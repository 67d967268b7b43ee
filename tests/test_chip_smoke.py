"""chip_smoke.py and bench.py: they refuse to run without a GPU, and the
smoke test's interop and main-path phases pass on the CPU at small Params.
The comparison phase runs on the card (marker ``gpu``)."""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import pvac_hfhe_cppbyv_tpu as pvac
from pvac_hfhe_cppbyv_tpu.parallel.engine import disable_device, enable_device

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(res):
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "metric" not in res.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """Under JAX_PLATFORMS=cpu, and in a directory holding only the script,
    chip_smoke.py exits non-zero and prints no ok line."""
    if where == "repo":
        res = _run(REPO / "chip_smoke.py", REPO)
        assert "needs 1 NVIDIA GPU" in res.stderr
    else:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        res = _run(tmp_path / "chip_smoke.py", tmp_path)
    _assert_refused(res)


def test_bench_refuses_without_gpu():
    res = _run(REPO / "bench.py", REPO)
    _assert_refused(res)
    assert "needs an NVIDIA GPU" in res.stderr


def test_chip_smoke_interop_on_cpu(chip_smoke, golden_small):
    chip_smoke.interop(golden_small, jax.devices("cpu")[0])


def test_chip_smoke_main_path_on_cpu(chip_smoke):
    pk, sk = pvac.keygen(pvac.small_test_params())
    eng = enable_device(pk, sk, device=jax.devices("cpu")[0])
    try:
        chip_smoke.main_path(pk, sk, eng, n_enc=32, n_add=8, n_mul=4)
    finally:
        disable_device(pk)


def test_chip_smoke_programs_on_cpu(chip_smoke):
    """Phases 2, 5 and 6 on the CPU engine (keys derived on the host):
    every program compiles, matches the host reference and is timed."""
    pk, sk = pvac.keygen(pvac.small_test_params())
    eng = enable_device(pk, sk, device=jax.devices("cpu")[0])
    try:
        progs = chip_smoke.Programs(eng, sk, prf_lanes=64, sigma_edges=256,
                                    mul_layers=4, mul_edges=120)
        compiled = chip_smoke.compile_programs(progs)
        assert sorted(compiled) == ["mulgrid", "prf[gn]", "prf[ng]", "sigma"]
        chip_smoke.against_reference(pk, sk, eng, progs, n_sigma_sample=32)
        chip_smoke.times(compiled, "cpu", host_prep=lambda: progs.host_prep(sk),
                         reps=1, copy_bytes=1 << 20)
    finally:
        disable_device(pk)


@pytest.mark.gpu
def test_chip_smoke_reference_on_gpu(chip_smoke, gpu_device):
    """Device PRF (keys derived on the card), σ and mulgrid bit-identical
    to the host reference, at small Params."""
    pk, sk = pvac.keygen(pvac.small_test_params())
    eng = enable_device(pk, sk, device=gpu_device)
    try:
        progs = chip_smoke.Programs(eng, sk, prf_lanes=256,
                                    sigma_edges=1024, mul_edges=300)
        chip_smoke.against_reference(pk, sk, eng, progs)
    finally:
        disable_device(pk)
