"""Agreement of the packed COO path with the padded float32 reference.

The padded modules (models/predictor.py, models/ggnn.py, models/heads.py)
and the packed COO predictor (models/packed.py) compute the same function
on the same parameter tree.  Run at ``highest`` matmul precision, the
padded modules are the plain reference that the trained, timed path is
checked against on the accelerator (chip_smoke.py)."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from gcnbmp_tpu.data.dataset import PairDataset, bucket_size


def _precision(p):
    return (jax.default_matmul_precision(p) if p is not None
            else contextlib.nullcontext())


def packed_and_reference_logits(cfg, params, ds: PairDataset,
                                reference_predictor, batch_size: int,
                                compute_dtype=None, path_precision=None):
    """Logits of every pair of ``ds`` through two paths, in dataset order.

    path: the wire-compact COO packed predictor built from ``cfg`` with
    ``compute_dtype`` (``jnp.bfloat16`` also stages the adjacency in bf16,
    as the Trainer does), under ``path_precision`` (None = XLA's default).
    reference: ``reference_predictor`` (the padded PairPredictor) under
    ``highest`` precision.  Returns ``(path, reference, labels)``."""
    from gcnbmp_tpu.data.packing import estimate_coo_capacities
    from gcnbmp_tpu.models.packed import make_packed_predictor
    from gcnbmp_tpu.train.loop import (
        collect_logits,
        collect_logits_coo,
        make_eval_step,
        make_eval_step_coo,
    )

    bf16 = compute_dtype == jnp.bfloat16
    packed = make_packed_predictor(
        fp_hidden_dim=cfg.fp_hidden_dim, fp_out_dim=cfg.fp_out_dim,
        conv_layers=cfg.conv_layers, weight_tying=cfg.weight_tying,
        sim_method=cfg.sim_method, class_num=cfg.class_num,
        net_hidden_dims=cfg.net_hidden_dims, coo=True, compact=True,
        adj_dtype=jnp.bfloat16 if bf16 else jnp.float32, method=cfg.method,
        layer_aggregator=cfg.layer_aggregator, compute_dtype=compute_dtype,
    )
    num_tiles, edge_capacity = estimate_coo_capacities([ds], batch_size)
    with _precision(path_precision):
        path, labels = collect_logits_coo(
            make_eval_step_coo(packed), params, ds, batch_size, num_tiles,
            edge_capacity)
    with _precision("highest"):
        ref, ref_labels = collect_logits(
            make_eval_step(reference_predictor), params, ds, batch_size,
            bucket_size(ds.max_atoms()))
    if not np.array_equal(labels, ref_labels):
        raise RuntimeError("packed and padded evaluation orders differ")
    return path, ref, labels
