#!/usr/bin/env python
"""Host-engine micro-benchmarks for the BASELINE.md rows that aren't
covered by bench.py: make_evalkey, ct_recrypt, ct_add, dec_value.

Writes docs/micro_bench.json.
Reference single-thread numbers (BASELINE.md, same host class):
keygen 1.16 s, evalkey(pool=8) 1.06 s, recrypt 18 ms, ct_add 6.7 us,
dec fresh 17 ms.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def best_of(fn, reps):
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        fn()
        best = min(best, time.time() - t0)
    return best


def main():
    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.ops.recrypt import ct_recrypt, make_evalkey

    prm = pvac.Params()
    t0 = time.time()
    pk, sk = pvac.keygen(prm)
    keygen_s = time.time() - t0
    keygen_s = min(keygen_s, best_of(lambda: pvac.keygen(prm), 1))

    ek_s = best_of(lambda: make_evalkey(pk, sk, 8, 1), 2)
    ek = make_evalkey(pk, sk, 8, 1)

    a, b = pvac.enc_value_batch(pk, sk, [111, 222])
    t0 = time.time()
    n_add = 200
    for _ in range(n_add):
        pvac.ct_add(pk, a, b)
    add_us = (time.time() - t0) / n_add * 1e6

    add_pairs = [(a, b)] * 64
    pvac.ct_add_batch(pk, add_pairs)
    t0 = time.time()
    for _ in range(10):
        pvac.ct_add_batch(pk, add_pairs)
    add_batch_us = (time.time() - t0) / 10 / 64 * 1e6

    prod = pvac.ct_mul(pk, a, b)
    ct_recrypt(pk, ek, prod)  # warm
    rec_ms = best_of(lambda: ct_recrypt(pk, ek, prod), 3) * 1e3
    r = ct_recrypt(pk, ek, prod)
    assert pvac.dec_value(pk, sk, r) == 111 * 222 % pvac.P

    cts = pvac.enc_value_batch(pk, sk, list(range(32)))
    dec_s = best_of(lambda: pvac.dec_value_batch(pk, sk, cts), 3)

    enc_s = best_of(lambda: pvac.enc_value_batch(pk, sk, list(range(32))), 3)

    mul_pairs = [(cts[2 * i], cts[2 * i + 1]) for i in range(16)] * 4
    pvac.ct_mul_batch(pk, mul_pairs)
    mul_s = best_of(lambda: pvac.ct_mul_batch(pk, mul_pairs), 2)

    out = {
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "engine": "host (numpy + native C++: AES-NI, SHA-NI)",
        "keygen_s": round(keygen_s, 3),
        "evalkey_pool8_s": round(ek_s, 3),
        "ct_add_us": round(add_us, 1),
        "ct_add_batch64_us": round(add_batch_us, 2),
        "recrypt_ms": round(rec_ms, 2),
        "dec_batch32_ct_s": round(32 / dec_s, 1),
        "enc_batch32_ct_s": round(32 / enc_s, 1),
        "mul_batch64_ops_s": round(64 / mul_s, 1),
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "micro_bench.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
