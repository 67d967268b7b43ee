#!/usr/bin/env python
"""Benchmark: homomorphic op throughput on one NVIDIA GPU.

Primary metric: ct_mul operations/second (fresh x fresh, default Params,
real end-to-end products incl. σ regeneration, timed with the device σ
queue fully drained), vs the reference C++ implementation's measured
155 ms/op (BASELINE.md) => baseline 6.45 ops/s.

Prints exactly one JSON line on stdout when every phase passed.  It exits
non-zero, with no JSON line, when JAX finds no GPU or any phase fails:
there is no host fallback.  ``PVAC_BENCH_QUICK=1`` runs small Params.
"""
import json
import os
import sys
import time

import numpy as np

T0 = time.time()
BASE_MUL = 6.45   # reference ct_mul ops/s (155 ms/op, BASELINE.md)
BASE_ENC = 12.5   # reference enc_value ct/s (~80 ms/op)


def log(*a):
    print(f"[{time.time()-T0:6.1f}s]", *a, file=sys.stderr, flush=True)


def rates(n, fn, reps):
    """fn() `reps` times after one warm-up call; returns n / seconds per
    rep, all reps, and the warm-up seconds."""
    t0 = time.time()
    fn()
    warm = time.time() - t0
    out = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        out.append(n / (time.time() - t0))
    return out, warm


def main():
    import jax

    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache
    from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs an NVIDIA GPU; JAX found {dev.platform!r}")
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    enable_compile_cache()

    quick = os.environ.get("PVAC_BENCH_QUICK") == "1"
    prm = pvac.small_test_params() if quick else pvac.Params()
    t0 = time.time()
    pk, sk = pvac.keygen(prm)
    log(f"keygen: {time.time() - t0:.1f}s")
    eng = enable_device(pk, sk, device=dev)
    P = pvac.P

    # ---- ct_mul (the headline metric) ----
    nb = 64 if quick else 512
    vals = list(range(1, 2 * nb + 1))
    cts = pvac.enc_value_batch(pk, sk, vals)
    pairs = [(cts[2 * i], cts[2 * i + 1]) for i in range(nb)]
    want = [vals[2 * i] * vals[2 * i + 1] % P for i in range(nb)]
    box = {}

    def mul():
        box["prods"] = pvac.ct_mul_batch(pk, pairs)
        eng.drain()

    mul_reps, warm = rates(nb, mul, 3)
    got = pvac.dec_value_batch(pk, sk, box["prods"])
    if got != want:
        raise AssertionError("ct_mul plaintexts differ")
    log(f"ct_mul batch {nb}: {[round(r, 1) for r in mul_reps]} ops/s "
        f"(warm-up {warm:.1f}s)")

    # ---- encryption and decryption on the device ----
    dvals = list(range(10_000, 10_000 + nb))

    def enc():
        box["cts"] = pvac.enc_value_batch(pk, sk, dvals)
        eng.drain()

    enc_reps, warm = rates(nb, enc, 3)
    log(f"enc batch {nb}: {[round(r, 1) for r in enc_reps]} ct/s "
        f"(warm-up {warm:.1f}s)")

    def dec():
        box["dec"] = pvac.dec_value_batch(pk, sk, box["cts"])

    dec_reps, warm = rates(nb, dec, 3)
    if box["dec"] != dvals:
        raise AssertionError("device decryption plaintexts differ")
    log(f"dec batch {nb}: {[round(r, 1) for r in dec_reps]} ct/s "
        f"(warm-up {warm:.1f}s)")

    mul_per_s = sorted(mul_reps)[len(mul_reps) // 2]
    print(json.dumps({
        "metric": "ct_mul_throughput",
        "value": round(mul_per_s, 3),
        "unit": "ops/s",
        "vs_baseline": round(mul_per_s / BASE_MUL, 2),
        "enc_ct_per_s": round(sorted(enc_reps)[1], 1),
        "dec_ct_per_s": round(sorted(dec_reps)[1], 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
