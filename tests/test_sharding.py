"""Multi-device sharded step: correctness on the virtual 8-CPU mesh.

Verifies that the (dp, tp)-sharded homomorphic step (psum'd LPN parity,
dp-parallel AES, psum'd bucket accumulation) computes exactly the same
field elements as the single-device engine path.
"""
import numpy as np
import pytest

import jax

from pvac_hfhe_cppbyv_tpu.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu.core import field as F
from pvac_hfhe_cppbyv_tpu.crypto import aesv, lpn
from pvac_hfhe_cppbyv_tpu.params import Params
from pvac_hfhe_cppbyv_tpu.parallel.mesh import make_mesh
from pvac_hfhe_cppbyv_tpu.parallel.sharding import make_multichip_step


@pytest.fixture(scope="module")
def tiny_prm():
    return Params(m_bits=512, n_bits=1024, h_col_wt=48, x_col_wt=32,
                  err_wt=32, lpn_n=256, lpn_t=256)


def test_multichip_step_matches_host(tiny_prm):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(devs[:8])
    step, build = make_multichip_step(mesh, tiny_prm, lanes_per_shard=32)
    args = build(seed=3)
    R, buckets = step(*args)
    R = np.asarray(R)
    buckets = np.asarray(buckets)

    # host recomputation: same keystreams -> same cores
    rk, nlo, nhi, trk, tnlo, tnhi, s32, bucket_ids = args
    # reconstruct keys is impossible (only round keys passed); instead feed
    # the same round keys through the aesv path
    N = nlo.shape[0]
    nblocks = lpn.n_ybits_blocks(tiny_prm)
    rkm = aesv.rk_masks_from_packed(rk, N)
    planes = aesv.counters_to_planes(nlo, nhi, nblocks)
    words = aesv.planes_to_words(aesv.encrypt_planes(rkm, planes), nblocks)
    lo = words[:, :, 0::2].reshape(N, -1)
    hi = words[:, :, 1::2].reshape(N, -1)
    u64s = np.stack([lo, hi], axis=-1)
    trkm = aesv.rk_masks_from_packed(trk, N)
    tplanes = aesv.counters_to_planes(tnlo, tnhi, 1)
    twords = aesv.planes_to_words(aesv.encrypt_planes(trkm, tplanes), 1)
    top_u = np.stack([twords[:, :, 0::2].reshape(N, -1),
                      twords[:, :, 1::2].reshape(N, -1)], axis=-1)
    want_R, _ = lpn.cores_from_streams(u64s, top_u, s32, tiny_prm)
    assert np.array_equal(R, want_R), "sharded PRF cores != host cores"

    # bucket sums mod p
    vals = FV.to_ints(want_R)
    want = [0] * tiny_prm.B
    for v, b in zip(vals, bucket_ids):
        want[int(b)] = F.fp_add(want[int(b)], v)
    got = FV.to_ints(buckets)
    assert got == want, "sharded bucket reduction mismatch"


def test_multichip_step_various_mesh_shapes(tiny_prm):
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    from jax.sharding import Mesh

    res = []
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = Mesh(np.asarray(devs[:4]).reshape(shape), ("dp", "tp"))
        step, build = make_multichip_step(mesh, tiny_prm, lanes_per_shard=32)
        args = build(seed=9)
        R, buckets = step(*args)
        res.append(np.asarray(buckets))
    # same inputs except lane counts differ per dp (N = 32*dp); compare the
    # shapes only across meshes, plus determinism within a mesh
    for r in res:
        assert r.shape == (tiny_prm.B, 4)


# ---------------------------------------------------------------------------
# Real ops sharded over the mesh (dp engine mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_keys():
    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.parallel.engine import (
        disable_device, enable_device,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    pk, sk = pvac.keygen(pvac.small_test_params())
    mesh = make_mesh(jax.devices()[:8])
    eng = enable_device(pk, sk, mesh=mesh)
    yield pk, sk, eng
    disable_device(pk)


def test_mesh_engine_sigma_bitexact(mesh_keys):
    """σ from the 8-device GSPMD engine == host-path σ, bit for bit."""
    from pvac_hfhe_cppbyv_tpu.crypto import matrix
    from pvac_hfhe_cppbyv_tpu.parallel.engine import disable_device

    pk, sk, eng = mesh_keys
    E = 37
    rng = np.random.default_rng(11)
    zt = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    nlo = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    nhi = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    idx = rng.integers(0, pk.prm.B, E, dtype=np.uint64)
    ch = rng.integers(0, 2, E, dtype=np.uint64)
    salt = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    sig_mesh = np.asarray(matrix.sigma_words(pk, zt, nlo, nhi, idx, ch, salt))
    disable_device(pk)
    try:
        sig_host = matrix.sigma_words(pk, zt, nlo, nhi, idx, ch, salt)
    finally:
        pk._engine = eng
    np.testing.assert_array_equal(sig_mesh, sig_host)


def test_mesh_engine_prf_bitexact(mesh_keys):
    """prf_R cores from the mesh engine == host numpy path, bit for bit."""
    from pvac_hfhe_cppbyv_tpu.parallel.engine import disable_device

    pk, sk, eng = mesh_keys
    N = 23
    rng = np.random.default_rng(13)
    seeds = rng.integers(0, 1 << 62, size=(N, 3), dtype=np.uint64)
    dh = np.array(
        [lpn.DOM_HASH[d] for d in ([
            "pvac.prf.r.1", "pvac.prf.r.2", "pvac.prf.r.3"] * N)][:N],
        dtype=np.uint64,
    )
    r_mesh = lpn.prf_cores_batch(pk, sk, seeds, dh)
    disable_device(pk)
    try:
        r_host = lpn.prf_cores_batch(pk, sk, seeds, dh)
    finally:
        pk._engine = eng
    np.testing.assert_array_equal(np.asarray(r_mesh), np.asarray(r_host))


def test_mesh_engine_real_ops_roundtrip(mesh_keys):
    """enc -> mul -> add -> dec with every hot kernel sharded over the
    8-device mesh; decrypts must be exact, and the host path must decrypt
    the SAME ciphertexts to the same values (bit-level interop)."""
    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.parallel.engine import disable_device

    pk, sk, eng = mesh_keys
    cts = pvac.enc_value_batch(pk, sk, [5, 7, 123])
    prod = pvac.ct_mul(pk, cts[0], cts[1])
    s = pvac.ct_add(pk, prod, cts[2])
    vals = pvac.dec_value_batch(pk, sk, cts + [prod, s])
    assert vals == [5, 7, 123, 35, 158]
    disable_device(pk)
    try:
        vals_host = pvac.dec_value_batch(pk, sk, cts + [prod, s])
    finally:
        pk._engine = eng
    assert vals_host == vals


def test_mesh_engine_prf_is_lpn_tensor_parallel(mesh_keys):
    """The REAL engine PRF program runs the LPN contraction tensor-parallel
    on a (dp, tp) mesh: the secret lives sharded P('tp') and the prf
    output is still bit-exact vs the host path.

    test_mesh_engine_prf_bitexact covers exactness; this asserts the tp
    configuration is actually ACTIVE (not silently fallen back)."""
    pk, sk, eng = mesh_keys
    assert eng.tp == 4 and eng._s32_tp, (eng.tp, eng._s32_tp)
    spec = tuple(eng.s32_dev.sharding.spec)
    assert spec == ("tp",), spec
    # the jitted prf fn for a padded lane count must be the shard_map path:
    # run one call and re-check exactness through it
    N = 64
    rng = np.random.default_rng(29)
    keys = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 62, N, dtype=np.uint64)
    r_mesh, rej = eng.prf_cores(keys, nonces, keys, nonces)

    from pvac_hfhe_cppbyv_tpu.crypto import aesv

    nblocks = lpn.n_ybits_blocks(pk.prm)
    rk = aesv.expand_keys_packed(keys)
    nlo = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nhi = (nonces >> np.uint64(32)).astype(np.uint32)
    planes = aesv.counters_to_planes(nlo, nhi, nblocks)
    words = aesv.planes_to_words(
        aesv.encrypt_planes(aesv.rk_masks_from_packed(rk, N), planes), nblocks)
    lo = words[:, :, 0::2].reshape(N, -1)
    hi = words[:, :, 1::2].reshape(N, -1)
    u64s = np.stack([lo, hi], axis=-1)
    tplanes = aesv.counters_to_planes(nlo, nhi, 1)
    twords = aesv.planes_to_words(
        aesv.encrypt_planes(aesv.rk_masks_from_packed(rk, N), tplanes), 1)
    top_u = np.stack([twords[:, :, 0::2].reshape(N, -1),
                      twords[:, :, 1::2].reshape(N, -1)], axis=-1)
    want_r, want_rej = lpn.cores_from_streams(
        u64s, top_u, sk.s_words32().reshape(-1), pk.prm)
    np.testing.assert_array_equal(np.asarray(r_mesh), want_r)
    np.testing.assert_array_equal(np.asarray(rej), want_rej.any(axis=-1))


@pytest.mark.slow
def test_mesh_engine_default_params_roundtrip():
    """enc -> mul -> add -> dec at PRODUCTION shape (default Params,
    m_bits=8192: tp-sharded 256-word σ rows, compact-transfer program,
    LPN-tp PRF) on the 8-device (dp=2, tp=4) virtual mesh, with a host
    decrypt cross-check."""
    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.parallel.engine import (
        disable_device, enable_device,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    pk, sk = pvac.keygen(Params())
    mesh = make_mesh(jax.devices()[:8])
    eng = enable_device(pk, sk, mesh=mesh)
    try:
        assert eng.tp == 4 and eng._s32_tp
        assert tuple(eng.Hx_dev.sharding.spec) == (None, "tp")
        cts = pvac.enc_value_batch(pk, sk, [9, 31])
        prod = pvac.ct_mul(pk, cts[0], cts[1])
        s = pvac.ct_add(pk, prod, cts[0])
        assert pvac.dec_value_batch(pk, sk, cts + [prod, s]) == \
            [9, 31, 279, 288]
        disable_device(pk)
        assert pvac.dec_value_batch(pk, sk, cts + [prod, s]) == \
            [9, 31, 279, 288]
    finally:
        disable_device(pk)


def test_mesh_engine_sigma_is_tensor_parallel(mesh_keys):
    """On a 2-D (dp, tp) mesh the engine holds H column-sharded over tp
    and produces σ sharded over BOTH axes — real tensor parallelism in a
    real op, with zero collectives (each chip gathers its own word slice
    of the selected H rows)."""
    from jax.sharding import PartitionSpec as P

    pk, sk, eng = mesh_keys
    assert eng.tp == 4 and eng.n_dev == 2  # make_mesh(8) -> (dp=2, tp=4)
    spec = eng.Hx_dev.sharding.spec
    assert tuple(spec) == (None, "tp"), spec

    from pvac_hfhe_cppbyv_tpu.crypto import matrix

    E = 40
    rng = np.random.default_rng(17)
    sig_job = matrix.sigma_words_start(
        pk,
        rng.integers(0, 1 << 62, E, dtype=np.uint64),
        rng.integers(0, 1 << 62, E, dtype=np.uint64),
        rng.integers(0, 1 << 62, E, dtype=np.uint64),
        rng.integers(0, pk.prm.B, E, dtype=np.uint64),
        rng.integers(0, 2, E, dtype=np.uint64),
        rng.integers(0, 1 << 62, E, dtype=np.uint64),
    )
    sig = sig_job.sig  # device-resident, pre-fetch
    # the word axis stays tp-sharded end to end (the lane axis of this
    # tiny remainder batch may be replicated by the post-jit slice)
    sspec = tuple(sig.sharding.spec)
    assert sspec and sspec[-1] == "tp", sspec
