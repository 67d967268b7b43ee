#!/usr/bin/env python
"""Multi-device scaling report for the real ops.

Runs the actual enc/dec/ct_mul pipeline with the engine in dp-mesh mode at
1/2/4/8 devices and reports two things:

1. **Partition efficiency** (hardware-independent): per-device compiled
   cost (XLA cost_analysis flops / bytes) of the PRF-core and σ programs
   at a fixed global batch.  Perfect data-parallel sharding shows cost(n)
   = cost(1)/n with zero collective bytes — this is the number that
   predicts real multi-chip scaling, because the dp axis has no
   cross-device dependencies at all.
2. **Wall-clock throughput** (host-bound on this box): enc_value ct/s on
   the virtual CPU mesh.  NOTE: the virtual devices share this host's
   physical cores (nproc reported below), so wall-clock cannot speed up
   past the host's core count — it is a sanity row, not the scaling claim.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           python benchmarks/scaling.py [--out docs/SCALING_TABLE.md]
"""
import argparse
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--lanes", type=int, default=2048,
                    help="global PRF lane count for the cost analysis")
    ap.add_argument("--enc-n", type=int, default=16,
                    help="enc_value batch for the wall-clock row")
    args = ap.parse_args()

    import jax

    from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache

    enable_compile_cache()

    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.crypto import aesv, lpn
    from pvac_hfhe_cppbyv_tpu.parallel.engine import (
        disable_device, enable_device,
    )
    from pvac_hfhe_cppbyv_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    counts = [n for n in (1, 2, 4, 8) if n <= len(devs)]
    print(f"# devices available: {len(devs)} ({devs[0].platform}); "
          f"host cores: {os.cpu_count()}", flush=True)

    prm = pvac.small_test_params()
    pk, sk = pvac.keygen(prm)

    rng = np.random.default_rng(7)
    N = args.lanes
    keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    tkeys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 63, size=N, dtype=np.uint64)
    tnonces = rng.integers(0, 1 << 63, size=N, dtype=np.uint64)

    rows = []
    base = {}
    for n in counts:
        mesh = make_mesh(devs[:n], shape=(n, 1))
        eng = enable_device(pk, sk, mesh=mesh)

        # --- per-device compiled cost of the PRF program at global N ---
        rk = aesv.expand_keys_packed(keys)
        trk = aesv.expand_keys_packed(tkeys)
        nlo = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        nhi = (nonces >> np.uint64(32)).astype(np.uint32)
        tnlo = (tnonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        tnhi = (tnonces >> np.uint64(32)).astype(np.uint32)
        fn = eng._prf_fn(N)
        compiled = fn.lower(rk, nlo, nhi, trk, tnlo, tnhi,
                            eng.s32_dev).compile()
        ca = compiled.cost_analysis()
        flops = float(ca.get("flops", 0.0))
        byts = float(ca.get("bytes accessed", 0.0))

        # --- wall-clock enc (host-bound sanity row) ---
        vals = list(range(args.enc_n))
        pvac.enc_value_batch(pk, sk, vals)  # warm compile
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            cts = pvac.enc_value_batch(pk, sk, vals)
        enc_rate = reps * args.enc_n / (time.time() - t0)
        got = pvac.dec_value_batch(pk, sk, cts[:2])
        assert got == vals[:2], f"decrypt mismatch at n={n}: {got}"

        disable_device(pk)
        if n == counts[0]:
            base = {"flops": flops, "bytes": byts}
        eff_f = base["flops"] / (n * flops) if flops else float("nan")
        rows.append((n, flops, byts, eff_f, enc_rate))
        print(f"n={n}: per-device flops {flops:.3e} bytes {byts:.3e} "
              f"partition-eff {100*eff_f:.1f}% | enc {enc_rate:.1f} ct/s",
              flush=True)

    lines = [
        "| devices | per-device PRF flops | per-device bytes | partition efficiency | enc ct/s (2-core host) |",
        "|---|---|---|---|---|",
    ]
    for n, flops, byts, eff_f, enc_rate in rows:
        lines.append(f"| {n} | {flops:.3e} | {byts:.3e} | "
                     f"{100*eff_f:.1f}% | {enc_rate:.1f} |")
    table = "\n".join(lines)
    print(table)
    if args.out:
        pathlib.Path(args.out).write_text(table + "\n")
        print(f"wrote {args.out}")
    # machine-readable copy for the SCALING.md generator
    import json

    art = pathlib.Path(__file__).resolve().parent.parent / "docs" / \
        "partition_efficiency.json"
    art.write_text(json.dumps({
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "platform": devs[0].platform,
        "host_cores": os.cpu_count(),
        "lanes": args.lanes,
        "rows": [
            {"devices": n, "per_device_flops": flops, "per_device_bytes": b,
             "partition_eff": eff, "enc_ct_s": rate}
            for n, flops, b, eff, rate in rows
        ],
    }, indent=1))
    print(f"wrote {art}")


if __name__ == "__main__":
    main()
