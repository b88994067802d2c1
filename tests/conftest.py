"""Test configuration: JAX runs on the CPU with 8 virtual devices, so the
sharding tests exercise a multi-device mesh without accelerators.

Tests marked ``gpu`` need a card; they take the ``gpu_devices`` fixture,
which skips them when JAX finds no GPU.  Run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu``.
"""

import os

# XLA reads XLA_FLAGS when the CPU backend is created (lazily, after this
# file runs), so the virtual-device-count flag can still go via env.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(2018)


@pytest.fixture
def gpu_devices():
    """JAX's GPU devices; skips the test when there are none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (JAX found none)")
    return devices


# ---- suite tiers: `pytest -m smoke` is the fast tier covering every
# layer (chem, packing, models, co-attention, eval, CLIs end-to-end via
# test_real_data_compat, plus a couple of quick multi-device checks);
# `-m "not slow"` drops only the long 8-vdev grad-parity batteries.

SMOKE_FILES = {
    "test_smiles.py", "test_featurize.py", "test_splits.py",
    "test_synth_dataset.py", "test_native.py", "test_native_pack.py",
    "test_models.py", "test_encoders.py", "test_coattention.py",
    "test_packing.py", "test_slotgather.py", "test_eval.py",
    "test_losses_multilabel.py", "test_fixed_embeddings.py",
    "test_prefetch.py", "test_rdkit_crosscheck.py",
    "test_real_data_compat.py", "test_nn.py", "test_runtime.py",
    "test_metrics_numpy.py",
}

SMOKE_TESTS = {
    "test_parallel.py::test_pairlocal_packer_device_locality",
    "test_parallel.py::test_dp_tp_sharded_step_matches_single_device",
}

SLOW_TESTS = {  # >60s each on a CPU
    "test_edgeshard_gwm_matches_single_device",
    "test_edgeshard_coattn_matches_single_device",
    "test_edgeshard_coattn_pairlocal_matches_single_device",
    "test_edgeshard_coo_bf16_matches_single_device",
    "test_edgeshard_loss_matches_single_device",
    "test_edgeshard_coo_loss_matches_single_device",
    "test_edgeshard_focal_and_hinge_losses_match_single_device",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = os.path.basename(str(item.fspath))
        base = item.name.split("[")[0]
        if fname in SMOKE_FILES or f"{fname}::{base}" in SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)
        if base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
