"""Offline evaluation: metrics + per-pair drug-embedding export.

Re-expresses the reference's MyEvaluator + CSV exports
(eval_coattention.py:149-330 evaluate loop collecting y/t and the two
drug embeddings e1/e2; :355-398 add_representations /
add_representations_and_y; :462-468 eval_result.json).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from gcnbmp_tpu.data.dataset import PairDataset, batch_iterator
from gcnbmp_tpu.train.metrics import compute_metrics


@dataclass
class EvalResult:
    logits: np.ndarray
    labels: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    metrics: Dict[str, float]


class PairEvaluator:
    """Runs predictor.predict over a dataset, collecting logits, labels,
    and the pair's molecular embeddings."""

    def __init__(self, predictor, params, batch_size: int = 32,
                 pad_to: Optional[int] = None, class_num: int = 1,
                 supernode_fn=None, class_names=None):
        self.predictor = predictor
        self.params = params
        self.batch_size = batch_size
        self.pad_to = pad_to
        self.class_num = class_num
        self.supernode_fn = supernode_fn
        self.class_names = class_names

        uses_supers = supernode_fn is not None

        @jax.jit
        def eval_fn(params, atoms1, adj1, atoms2, adj2, mask1, mask2, supers):
            kwargs = (
                {"super1": supers[0], "super2": supers[1]} if uses_supers else {}
            )
            logits, aux = predictor.apply(
                {"params": params}, atoms1, adj1, atoms2, adj2, mask1, mask2,
                deterministic=True, return_aux=True, **kwargs,
            )
            return logits, aux["g1"], aux["g2"]

        self._eval_fn = eval_fn

    def evaluate(self, ds: PairDataset) -> EvalResult:
        logits_all, labels_all, e1_all, e2_all = [], [], [], []
        if self.pad_to is None:
            from gcnbmp_tpu.data.dataset import bucket_size

            pad_to = bucket_size(ds.max_atoms())
        else:
            pad_to = self.pad_to
        for batch in batch_iterator(
            ds, self.batch_size, shuffle=False, pad_to=pad_to,
            supernode_fn=self.supernode_fn,
        ):
            supers = (
                (jnp.asarray(batch.super1), jnp.asarray(batch.super2))
                if batch.super1 is not None else ()
            )
            logits, g1, g2 = self._eval_fn(
                self.params,
                jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
                jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
                jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
                supers,
            )
            labels = np.asarray(batch.labels)
            logits = np.asarray(logits).reshape(
                labels.shape if self.class_num == 1 else (labels.shape[0], -1)
            )
            valid = (
                (labels >= 0).all(axis=-1) if labels.ndim > 1 else labels >= 0
            )
            logits_all.append(logits[valid])
            labels_all.append(labels[valid])
            e1_all.append(np.asarray(g1)[valid])
            e2_all.append(np.asarray(g2)[valid])
        logits = np.concatenate(logits_all)
        labels = np.concatenate(labels_all)
        metrics = compute_metrics(
            logits, labels, self.class_num, class_names=self.class_names
        )
        return EvalResult(
            logits=logits, labels=labels,
            e1=np.concatenate(e1_all), e2=np.concatenate(e2_all),
            metrics=metrics,
        )


class PackedPairEvaluator:
    """PairEvaluator over the packed COO fast path (the serving path).
    Usable for any run whose
    config rode a packed compute path (method in PACKED_ENCODERS, no
    supernodes/symmetric); co-attention configs ride the compact coattn
    layout.  Produces the same logits and embeddings as PairEvaluator
    (parameter trees are interchangeable; parity is tested)."""

    def __init__(self, train_cfg, params, batch_size: int = 512,
                 class_num: int = 1, class_names=None):
        from gcnbmp_tpu.models.packed import make_packed_predictor

        self.cfg = train_cfg
        self.params = params
        self.batch_size = batch_size
        self.class_num = class_num
        self.class_names = class_names
        self.predictor = make_packed_predictor(
            fp_hidden_dim=train_cfg.fp_hidden_dim,
            fp_out_dim=train_cfg.fp_out_dim,
            conv_layers=train_cfg.conv_layers,
            weight_tying=train_cfg.weight_tying,
            sim_method=train_cfg.sim_method, class_num=class_num,
            net_hidden_dims=train_cfg.net_hidden_dims, compact=True,
            attn=train_cfg.attn, method=train_cfg.method,
            layer_aggregator=train_cfg.layer_aggregator,
        )

        @jax.jit
        def eval_fn(params, args):
            return self.predictor.apply(
                {"params": params}, *args, return_g=True
            )

        self._eval_fn = eval_fn

    def evaluate(self, ds: PairDataset) -> EvalResult:
        from gcnbmp_tpu.data.packing import estimate_coo_capacities
        from gcnbmp_tpu.models.packed import (
            compact_coattn_arrays,
            compact_coo_arrays,
        )
        from gcnbmp_tpu.train.loop import iter_coo_eval_batches

        bs = min(self.batch_size, len(ds))
        num_tiles, edge_capacity = estimate_coo_capacities([ds], bs)
        if self.cfg.attn is not None:
            n_max = max(
                max(g.num_atoms for g in ds.graphs1),
                max(g.num_atoms for g in ds.graphs2),
            )
            n_max = ((n_max + 7) // 8) * 8
            args_fn = lambda b: compact_coattn_arrays(b, n_max)
        else:
            args_fn = compact_coo_arrays

        logits_all, labels_all, e1_all, e2_all = [], [], [], []
        for batch, valid in iter_coo_eval_batches(
            ds, bs, num_tiles, edge_capacity
        ):
            args = tuple(jnp.asarray(a) for a in args_fn(batch))
            logits, g1, g2 = self._eval_fn(self.params, args)
            labels = np.asarray(batch.labels)
            logits = np.asarray(logits).reshape(
                labels.shape if self.class_num == 1
                else (labels.shape[0], -1)
            )
            labels = labels[:valid]
            # drop ignore-labeled rows (label < 0), matching PairEvaluator
            keep = (
                (labels >= 0).all(axis=-1) if labels.ndim > 1
                else labels >= 0
            )
            logits_all.append(logits[:valid][keep])
            labels_all.append(labels[keep])
            # embeddings are per-PAIR (g1 = left mol of pair i)
            e1_all.append(np.asarray(g1)[:valid][keep])
            e2_all.append(np.asarray(g2)[:valid][keep])
        logits = np.concatenate(logits_all)
        labels = np.concatenate(labels_all)
        metrics = compute_metrics(
            logits, labels, self.class_num, class_names=self.class_names
        )
        return EvalResult(
            logits=logits, labels=labels,
            e1=np.concatenate(e1_all), e2=np.concatenate(e2_all),
            metrics=metrics,
        )


def _packed_eval_eligible(train_cfg, supernode_fn) -> bool:
    if train_cfg is None or supernode_fn is not None:
        return False
    if getattr(train_cfg, "compute_path", "padded") not in (
        "packed", "coo", "fused",
    ):
        return False
    # single source of truth for packed-path compatibility (the same
    # predicate the Trainer enforces at training time)
    from gcnbmp_tpu.train.loop import packed_config_problems

    return not packed_config_problems(train_cfg, allow_attn=True)


def _float_list_to_str(v: np.ndarray) -> str:
    return " ".join(f"{x:.6g}" for x in np.ravel(v))


def export_representations(
    source_csv: str,
    out_dir: str,
    result: EvalResult,
    id_cols: Tuple[str, str] = ("drugbank_id_1", "drugbank_id_2"),
    generate_drug_list: bool = True,
    is_successful: Optional[np.ndarray] = None,
) -> None:
    """Write <test>_e.csv, <test>_e_y.csv, drug_list_with_representation.csv
    (reference: eval_coattention.py:355-398)."""
    os.makedirs(out_dir, exist_ok=True)
    df = pd.read_csv(source_csv)
    if is_successful is not None:
        df = df[np.asarray(is_successful)].reset_index(drop=True)
    if len(result.e1) != len(df):
        # evaluators drop ignore-labeled (label < 0 / NaN) rows, which
        # the is_successful mask cannot see — refuse to write misaligned
        # exports rather than silently pairing rows with wrong embeddings
        raise ValueError(
            f"export alignment mismatch: {len(result.e1)} evaluated rows "
            f"vs {len(df)} parseable CSV rows (does the CSV contain "
            "negative/NaN labels?)"
        )
    base = os.path.splitext(os.path.basename(source_csv))[0]
    e1 = [_float_list_to_str(x) for x in result.e1]
    e2 = [_float_list_to_str(x) for x in result.e2]
    out = df.copy()
    out.insert(len(out.columns) - 1, "e1", e1)
    out.insert(len(out.columns) - 1, "e2", e2)
    out.to_csv(os.path.join(out_dir, f"{base}_e.csv"), index=False)
    out_y = out.copy()
    probs = 1.0 / (1.0 + np.exp(-result.logits))
    out_y["y"] = list(np.ravel(probs) if probs.ndim == 1 else probs.tolist())
    out_y.to_csv(os.path.join(out_dir, f"{base}_e_y.csv"), index=False)
    if generate_drug_list and all(c in df.columns for c in id_cols):
        mapping = dict(zip(df[id_cols[0]], e1))
        mapping.update(dict(zip(df[id_cols[1]], e2)))
        pd.DataFrame(
            {"cid": list(mapping.keys()), "entity": list(mapping.values())}
        ).to_csv(
            os.path.join(out_dir, "drug_list_with_representation.csv"),
            index=False,
        )


def evaluate_dataset(
    predictor, params, ds: PairDataset, out_dir: Optional[str] = None,
    source_csv: Optional[str] = None, batch_size: int = 32,
    class_num: int = 1, is_successful: Optional[np.ndarray] = None,
    supernode_fn=None, class_names=None, train_cfg=None,
) -> EvalResult:
    """One-call evaluation + optional exports + eval_result.json.

    When ``train_cfg`` is given and the run rode a packed compute path,
    evaluation rides the packed COO fast path (PackedPairEvaluator);
    otherwise the padded path."""
    if _packed_eval_eligible(train_cfg, supernode_fn):
        evaluator = PackedPairEvaluator(
            train_cfg, params, batch_size=batch_size, class_num=class_num,
            class_names=class_names,
        )
    else:
        evaluator = PairEvaluator(
            predictor, params, batch_size=batch_size, class_num=class_num,
            supernode_fn=supernode_fn, class_names=class_names,
        )
    result = evaluator.evaluate(ds)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "eval_result.json"), "w") as f:
            json.dump(result.metrics, f, indent=2)
        if source_csv:
            export_representations(
                source_csv, out_dir, result, is_successful=is_successful
            )
    return result
