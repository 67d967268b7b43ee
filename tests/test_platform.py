"""Platform choices of the device engine, the AES plane layouts it picks
between, and the placement of JAX's persistent compilation cache."""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from pvac_hfhe_cppbyv_tpu import config
from pvac_hfhe_cppbyv_tpu.crypto import aes, aesv
from pvac_hfhe_cppbyv_tpu.parallel import engine

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_cpu_engine_imports_no_pallas_module():
    """A CPU engine runs the whole scheme in plain XLA: no Pallas module is
    imported (in a fresh interpreter, so other tests cannot mask it)."""
    code = (
        "import sys\n"
        "import jax, pvac_hfhe_cppbyv_tpu as pvac\n"
        "from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device\n"
        "pk, sk = pvac.keygen(pvac.small_test_params())\n"
        "eng = enable_device(pk, sk, device=jax.devices('cpu')[0])\n"
        "assert (eng.aes_gn, eng.min_lanes) == (False, 32)\n"
        "c = pvac.enc_value_batch(pk, sk, [3, 4])\n"
        "assert pvac.dec_value_batch(pk, sk, c) == [3, 4]\n"
        "bad = [m for m in sys.modules if 'pallas' in m]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=600)


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(platform, small_keys):
    pk, sk = small_keys
    with pytest.raises(ValueError, match="no device programs"):
        engine.platform_choices(platform)

    class Device:
        pass

    dev = Device()
    dev.platform = platform
    with pytest.raises(ValueError, match=platform):
        engine.DeviceEngine(pk, sk, device=dev)
    assert not hasattr(pk, "_engine")


def test_platform_choices_cover_cpu_and_gpu_only():
    assert sorted(engine.PLATFORM_CHOICES) == ["cpu", "gpu"]
    assert engine.platform_choices("gpu") == {"aes_gn": True,
                                              "min_lanes": 2048}
    assert engine.platform_choices("cpu") == {"aes_gn": False,
                                              "min_lanes": 32}


@pytest.mark.parametrize("n, n_pad", [(1, 32), (33, 64), (100, 128)])
def test_prf_key_args_pad_lanes_and_expand_on_host(n, n_pad, small_keys):
    """The PRF program's inputs: lanes zero-padded to a power of two of at
    least min_lanes, keys expanded on the host into packed round-key
    planes, nonces split into u32 halves."""
    pk, sk = small_keys
    eng = engine.DeviceEngine(pk, sk, device=jax.devices("cpu")[0])
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    tkeys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 63, size=(n,), dtype=np.uint64)
    got_pad, args = eng.prf_key_args(keys, nonces, tkeys, nonces ^ 1)
    rk, nlo, nhi, trk, tnlo, tnhi, s32 = args
    assert got_pad == n_pad
    for k, planes in ((keys, rk), (tkeys, trk)):
        kp = np.zeros((n_pad, 32), dtype=np.uint8)
        kp[:n] = k
        assert planes.shape == (1920, n_pad // 32)
        np.testing.assert_array_equal(planes, aesv.expand_keys_packed(kp))
    for lo, hi, nn in ((nlo, nhi, nonces), (tnlo, tnhi, nonces ^ 1)):
        assert lo.shape == hi.shape == (n_pad,)
        assert not lo[n:].any() and not hi[n:].any()
        got = lo[:n].astype(np.uint64) | hi[:n].astype(np.uint64) << 32
        np.testing.assert_array_equal(got, nn)
    assert s32 is eng.s32_dev


def test_gpu_lane_padding(small_keys):
    """With the GPU's min_lanes every PRF and σ chunk pads to one of a few
    shapes: 2048 lanes and up, by powers of two."""
    pk, sk = small_keys
    eng = engine.DeviceEngine(pk, sk, device=jax.devices("cpu")[0])
    eng.min_lanes = engine.platform_choices("gpu")["min_lanes"]
    assert [eng._pad_lanes(n) for n in (1, 2048, 2049, 16384)] == [
        2048, 2048, 4096, 16384]


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_aes_layouts_match_each_other_and_the_oracle(backend):
    """The G-major and the N-major bitsliced layouts give the same keystream
    as the scalar table oracle, at a small N, under numpy and under jit."""
    rng = np.random.default_rng(29)
    N, nb = 32, 40
    keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, size=(N,), dtype=np.uint64)
    rk = aesv.rk_masks_from_packed(aesv.expand_keys_packed(keys), N)
    lo = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (nonces >> np.uint64(32)).astype(np.uint32)

    def ng(rk, lo, hi):
        return aesv.planes_to_words(
            aesv.encrypt_planes(rk, aesv.counters_to_planes(lo, hi, nb)), nb)

    def gn(rk, lo, hi):
        return aesv.planes_to_words_gn(
            aesv.encrypt_planes_gn(rk, aesv.counters_to_planes_gn(lo, hi, nb)),
            nb)

    if backend == "jax":
        import jax

        ng, gn = jax.jit(ng), jax.jit(gn)
    w_ng = np.asarray(ng(rk, lo, hi))
    w_gn = np.asarray(gn(rk, lo, hi))
    assert w_ng.shape == (N, nb, 4)
    np.testing.assert_array_equal(w_gn, w_ng)
    for n in (0, 17, N - 1):
        want = aes.AesCtr256(bytes(keys[n]), int(nonces[n])).fill_u64(2 * nb)
        words = w_gn[n].reshape(-1)
        got = [int(words[2 * t]) | int(words[2 * t + 1]) << 32
               for t in range(2 * nb)]
        assert got == want


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compile_cache_dir() == str(REPO / ".jax_cache")
