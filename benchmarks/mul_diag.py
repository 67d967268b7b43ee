#!/usr/bin/env python
"""Diagnose where ct_mul_batch wall time goes on the attached GPU.

Phases measured independently (all warm, min-of-reps):
  - device sigma program alone (8192-lane chunk, dispatch->fetch)
  - host staging alone (native cross agg + seed packing, engine disabled)
  - full ct_mul_batch at several batch sizes

Writes docs/mul_diag.json.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    out = {"ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    import jax
    import jax.numpy as jnp

    from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    out["device"] = str(dev)

    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device

    prm = pvac.Params()
    t0 = time.perf_counter()
    pk, sk = pvac.keygen(prm)
    out["keygen_s"] = round(time.perf_counter() - t0, 2)

    # ---- host-only ct_mul staging (engine off) ----
    cts = pvac.enc_value_batch(pk, sk, list(range(32)))
    pairs64 = [(cts[2 * (i % 16)], cts[2 * (i % 16) + 1]) for i in range(64)]
    t0 = time.perf_counter()
    host_prods = pvac.ct_mul_batch(pk, pairs64)
    host_first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        pvac.ct_mul_batch(pk, pairs64)
        best = min(best, time.perf_counter() - t0)
    out["host_mul64_s"] = round(best, 3)
    out["host_mul64_ops"] = round(64 / best, 1)
    n_edges = sum(p.n_edges for p in host_prods)
    out["edges_per_product"] = n_edges // 64
    print(f"host ct_mul_batch(64): {best:.3f}s ({64/best:.0f} ops/s), "
          f"{n_edges} edges", flush=True)

    # ---- device sigma program alone ----
    eng = enable_device(pk, sk, device=dev)
    E = 8192
    rng = np.random.default_rng(0)
    words = np.zeros((E, 7), dtype=np.uint64)
    words[:, 0] = np.uint64(pk.canon_tag)
    words[:, 1:4] = rng.integers(0, 1 << 63, (E, 3), dtype=np.uint64)
    words[:, 4] = rng.integers(0, prm.B, E, dtype=np.uint64)
    words[:, 5] = rng.integers(0, 2, E, dtype=np.uint64)
    words[:, 6] = rng.integers(0, 1 << 63, E, dtype=np.uint64)
    t0 = time.perf_counter()
    sig, fb = eng.sigma(words)
    np.asarray(fb)
    np.asarray(sig[:1])
    out["sigma_compile_s"] = round(time.perf_counter() - t0, 1)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sig, fb = eng.sigma(words)
        np.asarray(fb)
        np.asarray(sig[:1])
        best = min(best, time.perf_counter() - t0)
    out["sigma_8192_s"] = round(best, 3)
    out["sigma_edges_per_s"] = round(E / best)
    print(f"sigma(8192): {best*1e3:.0f} ms = {E/best:,.0f} edges/s "
          f"(compile {out['sigma_compile_s']}s)", flush=True)

    # prf program alone (one 1024-lane chunk)
    N = 1024
    keys = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 63, N, dtype=np.uint64)
    t0 = time.perf_counter()
    r, rej = eng.prf_cores(keys, nonces, keys, nonces)
    out["prf_compile_s"] = round(time.perf_counter() - t0, 1)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        eng.prf_cores(keys, nonces, keys, nonces)
        best = min(best, time.perf_counter() - t0)
    out["prf_1024_s"] = round(best, 3)
    out["prf_lanes_per_s"] = round(N / best)
    print(f"prf(1024): {best*1e3:.0f} ms = {N/best:,.0f} lanes/s "
          f"(compile {out['prf_compile_s']}s)", flush=True)

    # ---- full device ct_mul_batch ----
    for nb in (64, 128, 256, 512):
        ps = (pairs64 * ((nb + 63) // 64))[:nb]
        t0 = time.perf_counter()
        prods = pvac.ct_mul_batch(pk, ps)
        warm = time.perf_counter() - t0
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            prods = pvac.ct_mul_batch(pk, ps)
            best = min(best, time.perf_counter() - t0)
        # force drain of the sigma pipeline for honest accounting
        t0 = time.perf_counter()
        got = pvac.dec_value_batch(pk, sk, prods[:2])
        drain = time.perf_counter() - t0
        want = [
            pvac.dec_value(pk, sk, a) * pvac.dec_value(pk, sk, b) % pvac.P
            for a, b in ps[:2]
        ]
        assert got == want, (got, want)
        out[f"dev_mul{nb}_s"] = round(best, 3)
        out[f"dev_mul{nb}_ops"] = round(nb / best, 1)
        out[f"dev_mul{nb}_first_s"] = round(warm, 3)
        print(f"device ct_mul_batch({nb}): {best:.3f}s = {nb/best:.0f} ops/s"
              f" (first {warm:.1f}s, drain-check {drain:.2f}s)", flush=True)

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "mul_diag.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    os._exit(0)


if __name__ == "__main__":
    main()
