#!/usr/bin/env python
"""Depth stress sweep (mirror of reference tests/test_depth.cpp:25-74).

Repeated squaring c <- c*c at default Params, recording edges/layers/σ
density and mul/dec wall times per step.

Reference comparison (measured on this machine, g++ -O2 -march=native):
step 1 mul 105 ms, step 2 mul 1.28 s, step 3 mul 58.25 s — and at step 4
the reference ABORTS with std::bad_alloc under a 60 GB cap (44M edges x
~1KB of eager σ each).  This framework crosses step 4 via the device
dense-grid cross product (parallel/mulgrid.py) plus recipe-backed virtual
σ (types.VirtualSigma, ~12 B/edge until something reads the bits).

Usage: python benchmarks/depth_sweep.py [max_steps] [--csv out.csv] [--host]

--host runs without the device engine: every stage (native threaded
cross-product aggregation, native sigma XOR, AES-NI PRF) on the host
CPU — the configuration that beats the reference C++ at steps 1-3 with
no accelerator at all.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache

    enable_compile_cache()

    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.ops.encrypt import sigma_density
    from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device

    max_steps = 4
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if args:
        max_steps = int(args[0])
    csv_path = None
    if "--csv" in sys.argv:
        csv_path = sys.argv[sys.argv.index("--csv") + 1]

    host_only = "--host" in sys.argv
    prm = pvac.Params()
    t0 = time.time()
    pk, sk = pvac.keygen(prm)
    log(f"keygen: {time.time()-t0:.1f}s")
    if host_only:
        log("host engine (no device)")
    else:
        dev = jax.devices()[0]
        log(f"device: {dev}")
        enable_device(pk, sk, device=dev)

    c = pvac.enc_value(pk, sk, 2)
    expected = 2
    rows = []
    log(f"fresh: edges={c.n_edges} layers={c.n_layers}")
    for step in range(1, max_steps + 1):
        t0 = time.time()
        c = pvac.ct_mul(pk, c, c)
        mul_s = time.time() - t0
        expected = expected * expected % pvac.P
        t0 = time.time()
        got = pvac.dec_value(pk, sk, c)
        dec_s = time.time() - t0
        ok = got == expected
        from pvac_hfhe_cppbyv_tpu.types import VirtualSigma

        smode = "virtual" if isinstance(c.sigma, VirtualSigma) else "eager"
        dens = sigma_density(pk, c) if c.n_edges <= 200_000 else -1.0
        log(f"step={step} edges={c.n_edges} layers={c.n_layers} "
            f"dens={dens:.4f} sigma={smode} mul={mul_s:.2f}s dec={dec_s:.2f}s "
            f"{'ok' if ok else 'FAIL'}")
        rows.append((step, c.n_edges, c.n_layers, dens, smode, mul_s, dec_s,
                     int(ok)))
        assert ok, f"depth-{step} decrypt mismatch"

    if csv_path:
        with open(csv_path, "w") as f:
            f.write("step,edges,layers,density,sigma,mul_s,dec_s,ok\n")
            for r in rows:
                f.write(",".join(str(x) for x in r) + "\n")
        log(f"wrote {csv_path}")


if __name__ == "__main__":
    main()
