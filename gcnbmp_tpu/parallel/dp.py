"""Sharded training step: data-parallel batch + tensor-parallel wide
layers over a (data, model) mesh.

Design (no reference counterpart — SURVEY §2.9): inputs are sharded on
the batch axis across 'data'; selected weight matrices (the GGNN message
linear's 4H output and head MLP hiddens) are sharded on their output axis
across 'model'.  Everything else is replicated.  XLA inserts the psum for
gradient reduction and the all-gathers for the model-sharded activations
over the interconnect between the devices (NVLink between the GPUs of
one host).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcnbmp_tpu.train.loop import sigmoid_cross_entropy


def _param_spec(path: Tuple, leaf, model_axis_ok: bool) -> P:
    """Choose a PartitionSpec for one parameter leaf.

    Shard the output (last) axis of large kernels over 'model': the GGNN
    message GraphLinear (H -> 4H) and any Dense kernel with output width
    >= 256.  Biases and smaller kernels replicate (a lane-width shard of
    a <256 output would leave sublane-sized pieces per device).
    """
    if not model_axis_ok:
        return P()
    names = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    if leaf.ndim >= 2 and ("message" in names or leaf.shape[-1] >= 256):
        return P(*([None] * (leaf.ndim - 1) + ["model"]))
    return P()


def shard_params(params: Any, mesh: Mesh) -> Any:
    """Device_put params with (data, model)-mesh shardings."""
    model_ok = mesh.shape.get("model", 1) > 1

    def place(path, leaf):
        spec = _param_spec(path, leaf, model_ok)
        # output axis must divide evenly; fall back to replication
        if spec != P():
            axis = leaf.ndim - 1
            if leaf.shape[axis] % mesh.shape["model"] != 0:
                spec = P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, params)


def make_sharded_train_step(
    predictor,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    class_num: int = 1,
) -> Callable:
    """Build a jitted train step whose batch inputs are sharded over the
    'data' axis.  Call with already-sharded params (see shard_params)."""

    data_sh = NamedSharding(mesh, P("data"))

    def loss_fn(params, atoms1, adj1, atoms2, adj2, mask1, mask2, labels, rng):
        logits = predictor.apply(
            {"params": params},
            atoms1, adj1, atoms2, adj2, mask1, mask2,
            deterministic=False,
            rngs={"dropout": rng},
        )
        if class_num == 1:
            logits = jnp.reshape(logits, labels.shape)
        return sigmoid_cross_entropy(logits, labels)

    @jax.jit
    def step_fn(params, opt_state, atoms1, adj1, atoms2, adj2, mask1, mask2, labels, rng):
        atoms1 = jax.lax.with_sharding_constraint(atoms1, data_sh)
        atoms2 = jax.lax.with_sharding_constraint(atoms2, data_sh)
        adj1 = jax.lax.with_sharding_constraint(adj1, data_sh)
        adj2 = jax.lax.with_sharding_constraint(adj2, data_sh)
        loss, grads = jax.value_and_grad(loss_fn)(
            params, atoms1, adj1, atoms2, adj2, mask1, mask2, labels, rng
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step_fn
