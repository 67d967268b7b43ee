#!/usr/bin/env python
"""Measured rates for the host-side native kernels (C++: AES-NI, SHA-NI,
threaded) that carry the scheme when no accelerator is attached.

Writes docs/host_kernels.json.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    from pvac_hfhe_cppbyv_tpu import native
    from pvac_hfhe_cppbyv_tpu.types import Dom

    assert native.lib() is not None, "native runtime unavailable"
    rng = np.random.default_rng(0)
    rows = []

    # σ draw streams (SHA-NI + block-1 midstate)
    E = 20000
    w = rng.integers(0, 2**63, (E, 7), dtype=np.uint64)
    native.choose_k(Dom.X_SEED.encode(), w[:128], 128, 16384)  # warm
    t0 = time.time()
    native.choose_k(Dom.X_SEED.encode(), w, 128, 16384)
    dt = time.time() - t0
    rows.append({
        "kernel": "choose_k (sigma draws)", "rate": round(E / dt),
        "unit": "draw-lanes/s (k=128)",
        "note": "SHA-NI 1 compression per 32 B draw via block-1 midstate",
    })

    # σ column XOR (loop-inverted streaming)
    n_bits, mw, k, e = 16384, 256, 128, 128
    H = rng.integers(0, 2**32, (n_bits, mw), dtype=np.uint64).astype(np.uint32)
    E = 10784
    cols = rng.integers(0, n_bits, (E, k)).astype(np.int32)
    noise = rng.integers(0, mw * 32, (E, e)).astype(np.int32)
    native.sigma_xor(H, cols[:256], noise[:256])  # warm
    t0 = time.time()
    native.sigma_xor(H, cols, noise)
    dt = time.time() - t0
    rows.append({
        "kernel": "sigma_xor (H column XOR)", "rate": round(E / dt),
        "unit": "edges/s (128 x 1 KB rows each)",
        "note": "counting-sorted by row; H streamed, block accumulators "
                "cache-resident",
    })

    # ct_mul cross aggregation
    LA = LB = 32
    Bmod = 674
    nA = nB = 10784
    P = (1 << 127) - 1

    def mk(n, L):
        lid = rng.integers(0, L, n).astype(np.int32)
        idx = rng.integers(0, Bmod, n).astype(np.int32)
        ch = rng.integers(0, 2, n).astype(np.int8)
        ww = rng.integers(0, 2**31, (n, 4), dtype=np.uint64).astype(np.uint32)
        return lid, idx, ch, ww

    A, B = mk(nA, LA), mk(nB, LB)
    t0 = time.time()
    native.mul_cross_agg(*A, *B, LA, LB, Bmod)
    dt = time.time() - t0
    rows.append({
        "kernel": "mul_cross_agg (edge pairs)",
        "rate": round(nA * nB / dt / 1e6, 1),
        "unit": "M pairs/s (fp127 mul+add each)",
        "note": "dense keyspace accumulator, threads partitioned by "
                "A-side layer id",
    })

    # AES-256-CTR keystream (AES-NI)
    if native.lib() and getattr(native, "aes256_ctr", None):
        keys = rng.integers(0, 256, (64, 32), dtype=np.uint8)
        nblk = 4096
        t0 = time.time()
        got = native.aes256_ctr(keys, np.zeros(64, dtype=np.uint64), nblk)
        dt = time.time() - t0
        if got is not None:
            rows.append({
                "kernel": "aes256_ctr (PRF keystream)",
                "rate": round(64 * nblk / dt / 1e6, 1),
                "unit": "M AES blocks/s",
                "note": "AES-NI, threaded lanes",
            })

    out = {
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "host": f"{os.cpu_count()} cores, AES-NI + SHA-NI",
        "rows": rows,
    }
    with open(os.path.join(REPO, "docs", "host_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
