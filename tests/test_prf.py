"""PRF-R pipeline tests vs reference vectors.

Mirrors tests/test_prf.cpp / test_prf_ext.cpp (domain separation, values)
using exact reference-generated vectors for a synthetic key set.
"""
import numpy as np
import pytest

from pvac_hfhe_cppbyv_tpu.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu.params import Params
from pvac_hfhe_cppbyv_tpu.types import Dom, Nonce128, PubKey, RSeed, SecKey
from pvac_hfhe_cppbyv_tpu.crypto import lpn


@pytest.fixture(scope="module")
def synth(vectors):
    pi = vectors["prf_inputs"]
    sk = SecKey(
        prf_k=[int(x) for x in pi["prf_k"]],
        lpn_s_bits=[int(x) for x in pi["lpn_s_bits"]],
    )
    pk = PubKey(
        prm=Params(),
        canon_tag=int(pi["canon_tag"]),
        H=None,
        ubk=None,
        H_digest=bytes.fromhex(pi["H_digest"]),
        omega_B=0,
        powg_B=[],
    )
    seed = RSeed(
        ztag=int(pi["ztag"]),
        nonce=Nonce128(int(pi["nonce_lo"]), int(pi["nonce_hi"])),
    )
    return pk, sk, seed


def test_fnv1a(vectors):
    for dom, want in vectors["fnv1a"].items():
        assert lpn.fnv1a_domain(dom) == int(want)


def test_derive_aes_key(vectors, synth):
    pk, sk, seed = synth
    for case in vectors["derive_aes_key"]:
        key, nonce = lpn.derive_aes_key(pk, sk, seed, case["dom"])
        assert key.hex() == case["key"]
        assert nonce == int(case["nonce"])


def test_derive_keys_batch(vectors, synth):
    pk, sk, seed = synth
    doms = [c["dom"] for c in vectors["derive_aes_key"]]
    seeds = np.tile(
        np.array([[seed.ztag, seed.nonce.lo, seed.nonce.hi]], dtype=np.uint64),
        (len(doms), 1),
    )
    dh = np.array([lpn.fnv1a_domain(d) for d in doms], dtype=np.uint64)
    keys, nonces = lpn.derive_keys_batch(pk, sk, seeds, dh)
    for i, case in enumerate(vectors["derive_aes_key"]):
        assert bytes(keys[i]).hex() == case["key"]
        assert int(nonces[i]) == int(case["nonce"])



def test_lpn_ybits_first_words(vectors, synth):
    pk, sk, seed = synth
    yb = lpn.lpn_make_ybits(pk, sk, seed, Dom.PRF_R1, n_rows=128)
    want = [int(x) for x in vectors["lpn_ybits_r1_first2w"]]
    assert yb[0] == want[0]
    assert yb[1] == want[1]


def test_prf_R_core_and_products(vectors, synth):
    pk, sk, seed = synth

    def fp(words):
        return int(words[0]) | int(words[1]) << 64

    assert lpn.prf_R_core(pk, sk, seed, Dom.PRF_R1) == fp(vectors["prf_R_core_r1"])
    assert lpn.prf_R_core(pk, sk, seed, Dom.PRF_R2) == fp(vectors["prf_R_core_r2"])
    assert lpn.prf_R(pk, sk, seed) == fp(vectors["prf_R"])
    assert lpn.prf_R_noise(pk, sk, seed) == fp(vectors["prf_R_noise"])


def test_prf_R_batch(vectors, synth):
    pk, sk, seed = synth
    seeds = np.array(
        [[seed.ztag, seed.nonce.lo, seed.nonce.hi]] * 2, dtype=np.uint64
    )
    out = lpn.prf_R_batch(pk, sk, seeds)
    vals = FV.to_ints(out)
    want = int(vectors["prf_R"][0]) | int(vectors["prf_R"][1]) << 64
    assert vals == [want, want]
