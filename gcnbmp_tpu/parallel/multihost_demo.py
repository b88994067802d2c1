"""Executable multi-host edgeshard demo.

Run by tests/test_multihost.py as two OS processes (CPU backend, 4
virtual devices each, Gloo collectives):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python -m gcnbmp_tpu.parallel.multihost_demo <pid> <nproc> <coordinator>

Each process: jax.distributed bring-up, a global ("graph",) mesh over
all 8 devices, host-local feeding of a deterministic toy packed batch,
ONE edgeshard train step (replicated params, tile/pair-sharded batch,
molecule-table psum + grad reduction across processes), then prints

    MULTIHOST loss=<f> checksum=<f>

Single-process parity: ``reference_loss_and_checksum()`` runs the same
step on an in-process 8-device mesh; the test asserts both processes
print values equal to it (gradient parity through the cross-process
collectives).  The same code path runs across GPU hosts, where the
collectives run over NCCL instead of Gloo (SURVEY §2.9 / §5.8).
"""

from __future__ import annotations

import sys

import numpy as np

_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "C=O", "CCN", "COC", "CCCC", "OCCO"]


def demo_packed_batch(num_tiles: int = 8, n_pairs: int = 16, seed: int = 7):
    """Deterministic toy packed batch — identical on every process."""
    from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu.data.dataset import PairDataset
    from gcnbmp_tpu.data.packing import pack_pair_dataset_batch

    rng = np.random.default_rng(seed)
    feat = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(n_pairs):
        ds.append(
            feat(mol_from_smiles(_SMILES[int(rng.integers(len(_SMILES)))])),
            feat(mol_from_smiles(_SMILES[int(rng.integers(len(_SMILES)))])),
            np.float32(rng.integers(0, 2)),
        )
    return pack_pair_dataset_batch(ds, list(range(n_pairs)), num_tiles=num_tiles)


def _predictor_and_state():
    import jax
    import jax.numpy as jnp
    import optax

    from gcnbmp_tpu.models.packed import make_packed_predictor

    packed = demo_packed_batch()
    ppred = make_packed_predictor(
        fp_hidden_dim=16, fp_out_dim=16, conv_layers=4, weight_tying=True,
        sim_method="hole",
    )
    init_args = (
        jnp.asarray(packed.atom_ids), jnp.asarray(packed.adj),
        jnp.asarray(packed.mol_id), jnp.asarray(packed.node_mask),
        jnp.asarray(packed.left_index), jnp.asarray(packed.right_index),
    )
    params = ppred.init(jax.random.PRNGKey(0), *init_args)["params"]
    opt = optax.adam(1e-3)
    return packed, ppred, params, opt, opt.init(params)


def _checksum(tree) -> float:
    import jax

    return float(sum(
        float(np.sum(np.abs(np.asarray(x))))
        for x in jax.tree_util.tree_leaves(tree)
    ))


def run_step(shard_fn) -> tuple:
    """One edgeshard train step; ``shard_fn(packed, mesh)`` supplies the
    (multi-host or single-process) batch sharding."""
    import jax

    from gcnbmp_tpu.parallel.edgeshard import make_edgeshard_train_step

    packed, ppred, params, opt, opt_state = _predictor_and_state()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("graph",))
    step = make_edgeshard_train_step(ppred, opt, mesh, axis="graph")
    args = shard_fn(packed, mesh)
    params, opt_state, loss = step(params, opt_state, *args)
    return float(loss), _checksum(jax.device_get(params))


def reference_loss_and_checksum() -> tuple:
    """Single-process run over whatever devices this process sees."""
    from gcnbmp_tpu.parallel.edgeshard import shard_packed_batch

    return run_step(lambda p, m: shard_packed_batch(p, m, axis="graph"))


def main(process_id: int, num_processes: int, coordinator: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from gcnbmp_tpu.parallel.multihost import (
        initialize_multihost,
        shard_packed_batch_multihost,
    )

    initialize_multihost(coordinator, num_processes, process_id)
    assert jax.process_count() == num_processes
    loss, checksum = run_step(
        lambda p, m: shard_packed_batch_multihost(p, m, axis="graph")
    )
    print(f"MULTIHOST loss={loss:.8f} checksum={checksum:.6f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
