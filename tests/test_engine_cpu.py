"""Device-engine path on the CPU jax backend.

The DeviceEngine (parallel/engine.py) normally attaches to a GPU; here it is
attached to a CPU jax device, so the engine's control flow — prf_cores_async
dispatch, LazySigma device-resident views, the compact σ transfer form,
draws_and_take mask selection and sigma_finalize_many batched fallback
fetches — runs in CI.

Correctness oracle: the host (numpy + native) path, plus full enc/mul/dec
roundtrips through the scheme.
"""
import numpy as np
import pytest

import jax

import pvac_hfhe_cppbyv_tpu as pvac
from pvac_hfhe_cppbyv_tpu.crypto import matrix
from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device, disable_device
from pvac_hfhe_cppbyv_tpu.types import LazySigma


@pytest.fixture(scope="module")
def eng_keys():
    pk, sk = pvac.keygen(pvac.small_test_params())
    cpu = jax.devices("cpu")[0]
    eng = enable_device(pk, sk, device=cpu)
    yield pk, sk, eng
    disable_device(pk)


def test_engine_sigma_matches_host(eng_keys):
    pk, sk, eng = eng_keys
    E = 17
    rng = np.random.default_rng(3)
    zt = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    nlo = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    nhi = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    idx = rng.integers(0, pk.prm.B, E, dtype=np.uint64)
    ch = rng.integers(0, 2, E, dtype=np.uint64)
    salt = rng.integers(0, 1 << 62, E, dtype=np.uint64)

    sig_dev = np.asarray(matrix.sigma_words(pk, zt, nlo, nhi, idx, ch, salt))
    disable_device(pk)
    try:
        sig_host = matrix.sigma_words(pk, zt, nlo, nhi, idx, ch, salt)
    finally:
        pk._engine = eng
    np.testing.assert_array_equal(sig_dev, sig_host)


def test_engine_sigma_compact_form(eng_keys):
    """σ via the compact (per-layer seed table) transfer form must equal the
    expanded-lane form: canon_tag rows with idx<1024, ch<2 take the compact
    path, arbitrary ztag rows take the expanded path."""
    pk, sk, eng = eng_keys
    E = 9
    rng = np.random.default_rng(5)
    words = np.zeros((E, 7), dtype=np.uint64)
    words[:, 0] = pk.canon_tag
    words[:, 1] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    words[:, 2] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    words[:, 3] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    words[:, 4] = rng.integers(0, pk.prm.B, E, dtype=np.uint64)
    words[:, 5] = rng.integers(0, 2, E, dtype=np.uint64)
    words[:, 6] = rng.integers(0, 1 << 62, E, dtype=np.uint64)

    sig_compact, fb1, rows = eng.sigma(words.copy())
    # break the canon_tag precondition -> expanded path, then fix field 0
    w2 = words.copy()
    sig_exp, fb2 = eng._sigma_padded(w2)
    np.testing.assert_array_equal(
        np.asarray(sig_compact)[rows], np.asarray(sig_exp)[:E]
    )


def test_engine_sigma_multichunk_padded_rows(eng_keys):
    """Multi-chunk σ with a padded remainder: the (padded sig, valid rows)
    contract must reconstruct exactly the host σ through BOTH consumers —
    SigmaJob finalize and the LazySigma/fixer deferred path."""
    pk, sk, eng = eng_keys
    old_chunk = eng.SIGMA_CHUNK
    eng.SIGMA_CHUNK = 64  # force 2 full chunks + a padded remainder
    try:
        E = 64 + 64 + 17
        rng = np.random.default_rng(41)
        zt = rng.integers(0, 1 << 62, E, dtype=np.uint64)
        nlo = rng.integers(0, 1 << 62, E, dtype=np.uint64)
        nhi = rng.integers(0, 1 << 62, E, dtype=np.uint64)
        idx = rng.integers(0, pk.prm.B, E, dtype=np.uint64)
        ch = rng.integers(0, 2, E, dtype=np.uint64)
        salt = rng.integers(0, 1 << 62, E, dtype=np.uint64)

        job = matrix.sigma_words_start(pk, zt, nlo, nhi, idx, ch, salt)
        assert job.n_pad > E  # padding really present
        # consumer 1: deferred LazySigma over the padded base
        parts, fixer, vrows = matrix.sigma_deferred([job])
        assert len(vrows) == E
        lazy = np.asarray(LazySigma(parts[0], vrows, fixer))
        # consumer 2: direct finalize
        job2 = matrix.sigma_words_start(pk, zt, nlo, nhi, idx, ch, salt)
        fin = np.asarray(job2())
        disable_device(pk)
        try:
            want = matrix.sigma_words(pk, zt, nlo, nhi, idx, ch, salt)
        finally:
            pk._engine = eng
        np.testing.assert_array_equal(lazy, want)
        np.testing.assert_array_equal(fin, want)
    finally:
        eng.SIGMA_CHUNK = old_chunk


def test_engine_sigma_empty_batch(eng_keys):
    pk, sk, eng = eng_keys
    sig, fb, rows = eng.sigma(np.zeros((0, 7), dtype=np.uint64))
    assert sig.shape == (0, pk.prm.sigma_words32)
    assert np.asarray(fb).shape == (0,)
    assert rows.shape == (0,)


def test_engine_prf_cores_match_host(eng_keys):
    pk, sk, eng = eng_keys
    from pvac_hfhe_cppbyv_tpu.crypto import lpn

    rng = np.random.default_rng(11)
    N = 6
    seeds = rng.integers(0, 1 << 62, (N, 3), dtype=np.uint64)
    dh = np.array(
        [lpn.DOM_HASH[d] for d in (pvac.Dom.PRF_R1, pvac.Dom.PRF_R2,
                                   pvac.Dom.PRF_R3) * 2],
        dtype=np.uint64,
    )
    r_dev = lpn.prf_cores_batch(pk, sk, seeds, dh)
    disable_device(pk)
    try:
        r_host = lpn.prf_cores_batch(pk, sk, seeds, dh)
    finally:
        pk._engine = eng
    np.testing.assert_array_equal(np.asarray(r_dev), r_host)


def test_engine_roundtrip_enc_mul_dec(eng_keys):
    """Full scheme roundtrip with the engine attached: σ stays lazy/device-
    resident through enc -> combine -> mul -> dec, and serialization
    materializes it correctly."""
    pk, sk, eng = eng_keys
    a, b = 17, 29
    ca, cb = pvac.enc_value_batch(pk, sk, [a, b])
    # enc through the engine produces LazySigma views
    assert isinstance(ca.sigma, LazySigma) or not isinstance(
        ca.sigma, np.ndarray
    )
    prod = pvac.ct_mul(pk, ca, cb)
    s = pvac.ct_add(pk, prod, ca)
    got = pvac.dec_value_batch(pk, sk, [ca, cb, prod, s])
    assert got == [a, b, a * b % pvac.P, (a * b + a) % pvac.P]

    # serialize materializes lazy σ; roundtrips bit-exactly
    import tempfile

    from pvac_hfhe_cppbyv_tpu.io import serial

    with tempfile.NamedTemporaryFile(suffix=".ct") as f:
        serial.save_cts([s], f.name)
        (s2,) = serial.load_cts(f.name)
    assert pvac.dec_value(pk, sk, s2) == (a * b + a) % pvac.P


def test_engine_lazy_sigma_mixing(eng_keys):
    """Deliberately mix lazy σ across combine/compact/shuffle ordering; the
    materialized bytes must match an immediate materialization."""
    pk, sk, eng = eng_keys
    ca, cb = pvac.enc_value_batch(pk, sk, [5, 7])
    eager_a = np.asarray(ca.sigma).copy()
    eager_b = np.asarray(cb.sigma).copy()
    comb = pvac.ct_add(pk, ca, cb)
    lazy = np.asarray(comb.sigma)
    np.testing.assert_array_equal(
        lazy, np.concatenate([eager_a, eager_b])
    )


def test_deferred_fallback_fixer_patches_rows(eng_keys):
    """sigma_deferred returns device σ with no flag fetch; a forced
    fallback lane must be patched with the reference-exact scalar σ at
    materialization time (and only that lane)."""
    pk, sk, eng = eng_keys
    E = 6
    rng = np.random.default_rng(23)
    words = np.zeros((E, 7), dtype=np.uint64)
    words[:, 0] = pk.canon_tag
    words[:, 1] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    words[:, 2] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    words[:, 3] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    words[:, 4] = rng.integers(0, pk.prm.B, E, dtype=np.uint64)
    words[:, 5] = rng.integers(0, 2, E, dtype=np.uint64)
    words[:, 6] = rng.integers(0, 1 << 62, E, dtype=np.uint64)

    job = matrix.sigma_words_start(
        pk, words[:, 1], words[:, 2], words[:, 3],
        words[:, 4], words[:, 5], words[:, 6],
    )
    clean = np.asarray(job.sig).copy()  # padded on the engine path
    # force one "fallback" lane: corrupt its vectorized output and flag it
    # (fb stays in padded coordinates, job.rows maps valid -> padded)
    fb = np.zeros(job.n_pad, dtype=bool)
    row3 = 3 if job.rows is None else int(job.rows[3])
    fb[row3] = True
    corrupted = clean.copy()
    corrupted[row3] ^= 0xDEADBEEF
    job.sig = corrupted
    job.fb = fb

    bases, fixer, vrows = matrix.sigma_deferred([job])
    assert fixer._patches is None  # nothing fetched yet
    assert len(vrows) == E
    out = LazySigma(bases[0], vrows, fixer)
    got = np.asarray(out)
    assert got.shape[0] == E
    want3 = matrix._scalar_sigma_row(pk, pk.prm, words[3])
    np.testing.assert_array_equal(got[3], want3)
    valid = corrupted[vrows]
    mask = np.ones(E, dtype=bool)
    mask[3] = False
    np.testing.assert_array_equal(got[mask], valid[mask])
    # row-subset views patch consistently too
    sub = np.asarray(out[np.array([3, 1])])
    np.testing.assert_array_equal(sub[0], want3)
    np.testing.assert_array_equal(sub[1], valid[1])


def test_drain_reraises_recorded_sigma_failures(eng_keys):
    """A sigma chunk failure observed by the pacing throttle must surface
    at the next drain() (ADVICE r4: a warning alone is lost in long runs),
    and drain must clear the record so later windows start clean."""
    pk, sk, eng = eng_keys
    eng._sigma_failures.append(RuntimeError("synthetic chunk death"))
    with pytest.raises(RuntimeError, match="queued sigma chunk"):
        eng.drain()
    # record cleared: the next drain is clean
    eng.drain()
