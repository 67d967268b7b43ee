"""AES-256-CTR tests.

Mirrors tests/test_aes_ctr.cpp (KAT, fill/next consistency, key/nonce
separation, bounded) and verifies the bitsliced vector engine bit-exactly
against the scalar oracle and the reference-generated vectors.
"""
import numpy as np
import pytest

from pvac_hfhe_cppbyv_tpu.crypto import aes, aesv


def test_fips197_kat():
    key = bytes(range(32))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = aes.encrypt_block_256(aes.expand_key_256(key), pt)
    assert ct.hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_ctr_vectors(vectors):
    for case in vectors["aes256_ctr"]:
        a = aes.AesCtr256(bytes.fromhex(case["key"]), int(case["nonce"]))
        assert a.fill_u64(len(case["u64s"])) == [int(x) for x in case["u64s"]]
        if "bounded8_after40" in case:
            assert [a.bounded(8) for _ in range(8)] == [
                int(x) for x in case["bounded8_after40"]
            ]
            assert a.fill_u64(5) == [int(x) for x in case["u64s_after"]]


def test_fill_next_consistency():
    key = bytes(range(32))
    a = aes.AesCtr256(key, 77)
    b = aes.AesCtr256(key, 77)
    xs = [a.next_u64() for _ in range(11)]
    assert b.fill_u64(11) == xs


def test_sbox_circuit_exhaustive():
    # all 256 byte values through the bitsliced S-box (numpy planes)
    vals = np.arange(256, dtype=np.uint32).reshape(8, 32)
    sh = np.arange(32, dtype=np.uint32)
    planes = [(((vals >> np.uint32(b)) & 1) << sh).sum(axis=-1).astype(np.uint32)
              for b in range(8)]
    out = aesv.sbox_planes(planes)
    got = np.zeros((8, 32), dtype=np.uint32)
    for b in range(8):
        got |= (((out[b][:, None] >> sh) & 1) << np.uint32(b)).astype(np.uint32)
    want = np.array(aes.SBOX, dtype=np.uint32).reshape(8, 32)
    assert np.array_equal(got, want)


def test_bit_transpose_32():
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, 1 << 32, dtype=np.uint32, size=(5,)) for _ in range(32)]
    cols = aesv.bit_transpose_32(rows)
    for i in range(32):
        for j in range(32):
            assert np.array_equal(
                (cols[j] >> np.uint32(i)) & 1, (rows[i] >> np.uint32(j)) & 1
            )


def test_expand_keys_bitsliced():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 256, size=(7, 32), dtype=np.uint8)
    rk = aesv.expand_keys_bitsliced(keys)
    assert rk.shape == (15, 16, 8, 7)
    for n in range(7):
        kw = aes.expand_key_256(bytes(keys[n]))
        for r in range(15):
            for p in range(16):
                c, k = p // 4, p % 4
                byte = (kw[4 * r + c] >> (8 * (3 - k))) & 0xFF
                for b in range(8):
                    want = 0xFFFFFFFF if (byte >> b) & 1 else 0
                    assert int(rk[r, p, b, n]) == want, (n, r, p, b)


def test_ctr_keystream_matches_scalar():
    rng = np.random.default_rng(11)
    N, nblocks = 5, 40
    keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, size=(N,), dtype=np.uint64)
    u64s = aesv.ctr_keystream_u64(keys, nonces, nblocks)
    for n in range(N):
        sc = aes.AesCtr256(bytes(keys[n]), int(nonces[n]))
        want = sc.fill_u64(2 * nblocks)
        got = [int(u64s[n, t, 0]) | int(u64s[n, t, 1]) << 32 for t in range(2 * nblocks)]
        assert got == want


def test_ctr_keystream_jax_matches_numpy():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    N, nblocks = 3, 8
    keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, size=(N,), dtype=np.uint64)
    want = aesv.ctr_keystream_u64(keys, nonces, nblocks)

    rk = aesv.expand_keys_bitsliced(keys)
    nlo = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nhi = (nonces >> np.uint64(32)).astype(np.uint32)

    @jax.jit
    def run(rk, nlo, nhi):
        planes = aesv.counters_to_planes(nlo, nhi, nblocks)
        out = aesv.encrypt_planes(rk, planes)
        return aesv.planes_to_words(out, nblocks)

    words = np.asarray(run(jnp.asarray(rk), jnp.asarray(nlo), jnp.asarray(nhi)))
    lo = words[:, :, 0::2].reshape(N, -1)
    hi = words[:, :, 1::2].reshape(N, -1)
    got = np.stack([lo, hi], axis=-1)
    assert np.array_equal(got, np.asarray(want))


def test_sbox_tower_equals_fermat():
    # two independently-derived circuits must agree on all inputs
    vals = np.arange(256, dtype=np.uint32).reshape(8, 32)
    sh = np.arange(32, dtype=np.uint32)
    planes = [(((vals >> np.uint32(b)) & 1) << sh).sum(axis=-1).astype(np.uint32)
              for b in range(8)]
    a = aesv.sbox_planes(planes)
    b = aesv.sbox_planes_fermat(planes)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
