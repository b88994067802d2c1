"""Entry-point set-up: the GPU check, the compile-cache directory, the
benchmark's peak table, and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import bench
from gcnbmp_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu_devices():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_require_gpu_accepts_gpu_devices():
    fake = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            for _ in range(4)]
    assert runtime.require_gpu(fake) == fake


@pytest.mark.gpu
def test_require_gpu_on_a_card(gpu_devices):
    assert runtime.require_gpu(gpu_devices)[0].platform == "gpu"


@pytest.mark.parametrize("env_dir", [None, "cache-from-env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert runtime.enable_compile_cache() == os.path.join(
                REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == os.path.join(
                REPO, ".jax_cache")
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            assert runtime.enable_compile_cache() == path
            # the variable decides; nothing else is set in code
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_fixed():
    # the path is part of the cache key: it must not vary between runs
    assert runtime.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in runtime.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("key,value", [
    ("bf16_flops", 989e12), ("tf32_flops", 495e12), ("f32_flops", 67e12),
    ("hbm_bytes_per_s", 3.35e12),
])
def test_h100_peaks(key, value):
    assert bench.peaks_for("NVIDIA H100 80GB HBM3")[key] == value


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA L4", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_has_no_peak(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks_for(kind)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_bench_fails_without_gpu():
    proc = _run(["bench.py"], REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
