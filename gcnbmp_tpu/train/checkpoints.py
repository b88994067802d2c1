"""Checkpoint save/restore.

Replaces the reference's three Chainer serializer mechanisms (SURVEY §5.4:
trainer snapshots via save/load_npz, final model pickle, eval-time
snapshot overlay) with one ``.npz`` file of {params, opt_state,
step/epoch bookkeeping}.  Leaves are stored in the template's flattening
order and restored into the template's structure; loading never unpickles
(``allow_pickle=False``), so a checkpoint cannot run code.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from gcnbmp_tpu.train.loop import TrainState

SUFFIX = ".npz"


def _state_to_tree(state: TrainState) -> dict:
    return {
        "params": state.params,
        "opt_state": state.opt_state,
        "meta": {
            "step": np.asarray(state.step),
            "epoch": np.asarray(state.epoch),
            "best_val_loss": np.asarray(state.best_val_loss),
            "epochs_since_best": np.asarray(state.epochs_since_best),
        },
    }


def _tree_to_state(tree: dict) -> TrainState:
    meta = tree["meta"]
    return TrainState(
        params=tree["params"],
        opt_state=tree["opt_state"],
        step=int(meta["step"]),
        epoch=int(meta["epoch"]),
        best_val_loss=float(meta["best_val_loss"]),
        epochs_since_best=int(meta["epochs_since_best"]),
    )


def save_tree(path: str, tree) -> None:
    """Write a pytree's leaves to ``path`` (an ``.npz``), in flattening
    order."""
    leaves = jax.tree_util.tree_leaves(jax.device_get(tree))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, *[np.asarray(x) for x in leaves])


def load_tree(path: str, template):
    """Read a :func:`save_tree` file into ``template``'s structure,
    checking leaf count, shapes and dtypes."""
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(template))
    with np.load(path, allow_pickle=False) as data:
        stored = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(stored) != len(leaves):
        raise ValueError(
            f"{path}: {len(stored)} arrays, but the model needs {len(leaves)}")
    for i, (s, t) in enumerate(zip(stored, leaves)):
        t = np.asarray(t)
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(
                f"{path}: leaf {i} is {s.dtype}{list(s.shape)}, the model "
                f"expects {t.dtype}{list(t.shape)}")
    return jax.tree_util.tree_unflatten(treedef, stored)


def save_checkpoint(path: str, state: TrainState) -> None:
    save_tree(os.path.abspath(path) + SUFFIX, _state_to_tree(state))


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    path = os.path.abspath(path)
    if not os.path.exists(path + SUFFIX):
        raise FileNotFoundError(
            f"no checkpoint {path}{SUFFIX} (checkpoints written in an older "
            "format must be re-saved by the run that produced them)")
    return _tree_to_state(load_tree(path + SUFFIX, _state_to_tree(template)))
