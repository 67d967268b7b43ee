#!/usr/bin/env python
"""Measured host-vs-device time split for the real ops.

The number that limits multi-host scaling for an embarrassingly-parallel
dp workload is NOT communication (there is none) but the host:device work
ratio per host — if host staging exceeds device compute, adding hosts
scales anyway (each host brings its own CPUs), but adding CHIPS per host
does not.  This script measures, on the real device, at a realistic batch:

- enc_value_batch end-to-end wall time,
- the pure device time of the PRF programs the batch dispatches (measured
  by timing the exact chunk programs with materialization-forced sync),
- the pure device time of the σ programs,
- the derived host+link share = total − device.

Writes docs/host_device_split.json.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

import pvac_hfhe_cppbyv_tpu as pvac
from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache
from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
enable_compile_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fetch_one(out):
    leaf = jax.tree_util.tree_leaves(out)[0]
    idx = tuple(0 for _ in range(getattr(leaf, "ndim", 0)))
    np.asarray(jax.device_get(leaf[idx] if idx else leaf))


def bench_dev(fn, *args, reps=10, warm=1):
    out = None
    for _ in range(warm):
        out = fn(*args)
    fetch_one(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    fetch_one(out)
    return (time.perf_counter() - t0) / reps


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    dev = jax.devices()[0]
    log(f"device: {dev}; enc batch n={n}")
    prm = pvac.Params()
    pk, sk = pvac.keygen(prm)
    eng = enable_device(pk, sk, device=dev)

    vals = list(range(n))
    t0 = time.time()
    cts = pvac.enc_value_batch(pk, sk, vals)  # warm (compiles)
    eng.drain()
    warm_s = time.time() - t0
    log(f"enc warm: {warm_s:.1f}s")
    t_total = float("inf")
    for r in range(3):
        rep_vals = [v + r for v in vals]
        t0 = time.time()
        cts = pvac.enc_value_batch(pk, sk, rep_vals)
        eng.drain()  # the timed window must cover in-flight sigma chunks
        t_total = min(t_total, time.time() - t0)
    vals = rep_vals  # decrypt spot-check matches the last rep's plaintexts
    assert pvac.dec_value_batch(pk, sk, cts[:2]) == vals[:2]

    # --- reconstruct the device programs the batch dispatches ---
    # PRF: 2n layers x (3 + 3*(z2+z3-1)) requests, chunked at PRF_CHUNK
    from pvac_hfhe_cppbyv_tpu.ops.encrypt import plan_noise

    z2, z3 = plan_noise(pk, 0)
    reqs = 2 * n * (3 + 3 * max(0, z2 + z3 - 1))
    C = eng.PRF_CHUNK
    chunks = [C] * (reqs // C) + ([reqs % C] if reqs % C else [])
    rng = np.random.default_rng(3)

    t_prf_dev = 0.0
    for sz in sorted(set(chunks)):
        n_pad = eng._pad_lanes(sz)
        keys = rng.integers(0, 256, (sz, 32), dtype=np.uint16).astype(np.uint8)
        nonces = rng.integers(0, 1 << 63, sz, dtype=np.uint64)
        _, args = eng.prf_key_args(keys, nonces, keys, nonces)
        t = bench_dev(eng._prf_fn(n_pad), *args)
        t_prf_dev += t * chunks.count(sz)
        log(f"  prf chunk {sz} (pad {n_pad}): {t*1e3:.1f} ms device")

    # σ: one lane per merged edge; measure the compact-form program
    edges = sum(c.n_edges for c in cts)
    SC = eng.SIGMA_CHUNK
    sig_chunks = [SC] * (edges // SC) + ([edges % SC] if edges % SC else [])
    t_sig_dev = 0.0
    for sz in sorted(set(sig_chunks)):
        n_pad = eng._pad_lanes(sz)
        ltab = np.zeros((128, 3, 2), dtype=np.uint32)
        buf = rng.integers(0, 1 << 32, (n_pad, 3), dtype=np.uint64).astype(
            np.uint32
        )
        buf[:, 0] &= np.uint32((1 << 11) - 1)  # lid 0, idx/ch in range
        import jax.numpy as jnp

        fn = eng._sigma_compact_fn(n_pad, 128)
        t = bench_dev(fn, eng.Hx_dev, eng._canon2, jnp.asarray(ltab),
                      jnp.asarray(buf))
        t_sig_dev += t * sig_chunks.count(sz)
        log(f"  sigma chunk {sz} (pad {n_pad}): {t*1e3:.1f} ms device")

    t_dev = t_prf_dev + t_sig_dev
    host_share = max(0.0, t_total - t_dev)
    out = {
        "device": str(dev),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "enc_batch": n,
        "enc_total_s": round(t_total, 3),
        "enc_rate_ct_s": round(n / t_total, 1),
        "prf_device_s": round(t_prf_dev, 3),
        "sigma_device_s": round(t_sig_dev, 3),
        "device_share_pct": round(100 * t_dev / t_total, 1),
        "host_link_share_pct": round(100 * host_share / t_total, 1),
        "note": (
            "device times are the exact chunk programs re-timed with "
            "forced materialization; host+link = total - device (overlap "
            "makes this a lower bound on overlappable host work)"
        ),
    }
    path = os.path.join(REPO, "docs", "host_device_split.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {path}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
