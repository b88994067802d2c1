"""Process set-up shared by the entry points (the CLIs, ``bench.py`` and
``chip_smoke.py``): the persistent compilation cache and the accelerator
check.  Nothing here runs at import; each entry point calls what it
needs."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, decides the directory (JAX
    reads it itself, so nothing else is set).  Otherwise the cache lives
    at the fixed ``<repo>/.jax_cache``: the path is part of the cache
    key, so it never depends on a temporary name, a pid or the time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu(devices=None) -> list:
    """Return JAX's devices if they are GPUs; raise ``RuntimeError``
    otherwise, so a measurement never falls back to the CPU."""
    if devices is None:
        import jax

        devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {platform!r} "
            f"({devices[0].device_kind}); this entry point measures the "
            "accelerator and does not run on the CPU")
    return list(devices)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``; one line per card).  Runs nvidia-smi as a
    child process that never imports JAX."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
