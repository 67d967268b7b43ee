#!/usr/bin/env python
"""Basic usage tour (port of examples/basic_usage.cpp's 25-section demo).

Run:  python examples/basic_usage.py [--default-params] [--device]
"""
import argparse
import sys
import tempfile
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import pvac_hfhe_cppbyv_tpu as pvac
from pvac_hfhe_cppbyv_tpu import models


def section(title):
    print(f"\n--- {title} ---")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--default-params", action="store_true",
                    help="full-size Params (slower keygen)")
    ap.add_argument("--device", action="store_true",
                    help="route hot kernels to the attached accelerator")
    args = ap.parse_args()

    prm = pvac.Params() if args.default_params else pvac.small_test_params()

    section("keygen")
    t0 = time.time()
    pk, sk = pvac.keygen(prm)
    print(f"keygen: {time.time()-t0:.2f}s  (B={prm.B}, m={prm.m_bits}, "
          f"n={prm.n_bits}, LPN n={prm.lpn_n})")

    if args.device:
        from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device

        enable_device(pk, sk)
        print("device engine enabled")

    section("encrypt / decrypt")
    a, b = pvac.enc_value_batch(pk, sk, [42, 17])
    print("enc(42) ->", a, " enc(17) ->", b)
    print("dec:", pvac.dec_value_batch(pk, sk, [a, b]))

    section("homomorphic add / sub / scale")
    print("42+17 =", pvac.dec_value(pk, sk, pvac.ct_add(pk, a, b)))
    print("42-17 =", pvac.dec_value(pk, sk, pvac.ct_sub(pk, a, b)))
    print("42*1000 =", pvac.dec_value(pk, sk, pvac.ct_scale(pk, a, 1000)))

    section("homomorphic multiply")
    m = pvac.ct_mul(pk, a, b)
    print(f"42*17 = {pvac.dec_value(pk, sk, m)}  ({m})")

    section("polynomial x^2 + 3x + 5 at x=11")
    x = pvac.enc_value(pk, sk, 11)
    poly = models.eval_polynomial(
        pk, [5, 3, 1], x, lambda v: pvac.enc_value(pk, sk, v)
    )
    print("p(11) =", pvac.dec_value(pk, sk, poly))

    section("fibonacci / factorial chains")
    print("F(10) =", pvac.dec_value(pk, sk, models.fibonacci_chain(pk, sk, 10)))
    print("10! =", pvac.dec_value(pk, sk, models.factorial_chain(pk, sk, 10)))

    section("recrypt")
    ek = pvac.make_evalkey(pk, sk, 4, 0)
    r = pvac.ct_recrypt(pk, ek, pvac.ct_add(pk, a, b))
    print("recrypt(42+17) =", pvac.dec_value(pk, sk, r),
          f" density={pvac.sigma_density(pk, r):.4f}")

    section("commitment")
    print("commit(a) =", pvac.commit_ct(pk, a).hex()[:32], "...")

    section("text roundtrip")
    cts = pvac.enc_text(pk, sk, "homomorphic hello from the device")
    print("dec_text:", pvac.dec_text(pk, sk, cts))

    section("serialization")
    with tempfile.TemporaryDirectory() as tmp:
        pvac.save_cts([a, b, m], f"{tmp}/demo.ct")
        back = pvac.load_cts(f"{tmp}/demo.ct")
    print("roundtrip dec:", pvac.dec_value_batch(pk, sk, back))

    section("timing")
    t0 = time.time()
    batch = pvac.enc_value_batch(pk, sk, list(range(8)))
    t1 = time.time()
    pvac.dec_value_batch(pk, sk, batch)
    t2 = time.time()
    print(f"enc_value x8: {(t1-t0)*125:.1f} ms/ct   "
          f"dec_value x8: {(t2-t1)*125:.1f} ms/ct")
    print("\nall sections ok")


if __name__ == "__main__":
    main()
