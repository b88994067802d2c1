"""Training over fixed precomputed drug embeddings.

The reference's mol2vec / molecular-autoencoder / SSP baselines
(mol2vec_based_model.py, unsupervised_feature.py, my_utils/parsers.py
Mol2VecParserForPair:247 / MolAutoencoderParserForPair:454 /
SSPParserForPair:647) train only the scoring head over frozen per-drug
feature vectors.  Here: load an id->vector table, join it onto a pair
CSV, and fit a FixedEmbeddingPredictor head.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd

from gcnbmp_tpu.models.heads import HEADS
from gcnbmp_tpu.models.predictor import FixedEmbeddingPredictor
from gcnbmp_tpu.train.loop import sigmoid_cross_entropy
from gcnbmp_tpu.train.metrics import binary_metrics


def load_embedding_table(path: str, id_col: str = "cid",
                         vec_col: str = "entity") -> Dict[str, np.ndarray]:
    """Load id -> vector from a pickle dict or a CSV with a
    space-separated vector column (the drug_list_with_representation.csv
    format written by eval exports)."""
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            table = pickle.load(f)
        return {str(k): np.asarray(v, np.float32) for k, v in table.items()}
    df = pd.read_csv(path)
    return {
        str(row[id_col]): np.fromstring(str(row[vec_col]), sep=" ", dtype=np.float32)
        for _, row in df.iterrows()
    }


def pair_embeddings(
    pair_csv: str, table: Dict[str, np.ndarray],
    id_cols: Sequence[str] = ("drugbank_id_1", "drugbank_id_2"),
    label_col: str = "label",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    df = pd.read_csv(pair_csv)
    e1, e2, y = [], [], []
    for _, row in df.iterrows():
        a, b = str(row[id_cols[0]]), str(row[id_cols[1]])
        if a in table and b in table:
            e1.append(table[a])
            e2.append(table[b])
            y.append(float(row[label_col]))
    return np.stack(e1), np.stack(e2), np.asarray(y, np.float32)


def train_fixed_embedding_head(
    e1: np.ndarray, e2: np.ndarray, labels: np.ndarray,
    val: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    sim_method: str = "hole",
    class_num: int = 1,
    net_hidden_dims: Tuple[int, ...] = (32, 16),
    learning_rate: float = 1e-3,
    epochs: int = 100,
    batch_size: int = 128,
    seed: int = 2018,
) -> Dict:
    """Fit a scoring head over frozen embeddings; returns params + metrics."""
    predictor = _build_fixed_predictor(sim_method, class_num, net_hidden_dims)
    rng = jax.random.PRNGKey(seed)
    variables = predictor.init(rng, jnp.asarray(e1[:2]), jnp.asarray(e2[:2]))
    params = variables["params"]
    tx = optax.adam(learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, a, b, y):
        def loss_fn(p):
            logits = predictor.apply({"params": p}, a, b)
            return sigmoid_cross_entropy(jnp.reshape(logits, y.shape), y)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    np_rng = np.random.default_rng(seed)
    n = len(labels)
    # datasets smaller than batch_size would otherwise train ZERO steps
    # (and leave `loss` unbound below)
    batch_size = min(batch_size, n)
    losses = []
    for _ in range(epochs):
        order = np_rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            params, opt_state, loss = step(
                params, opt_state, jnp.asarray(e1[idx]), jnp.asarray(e2[idx]),
                jnp.asarray(labels[idx]),
            )
        losses.append(float(loss))

    @jax.jit
    def infer(p, a, b):
        return predictor.apply({"params": p}, a, b)

    out = {"params": params, "losses": losses}
    logits = np.asarray(infer(params, jnp.asarray(e1), jnp.asarray(e2)))
    out["train_metrics"] = binary_metrics(logits, labels)
    if val is not None:
        v1, v2, vy = val
        vlogits = np.asarray(infer(params, jnp.asarray(v1), jnp.asarray(v2)))
        out["val_metrics"] = binary_metrics(vlogits, vy)
    return out


def _build_fixed_predictor(sim_method: str, class_num: int,
                           net_hidden_dims: Tuple[int, ...]):
    head_kwargs = {"out_dim": class_num}
    if sim_method in ("hole", "mlp", "symmlp", "ntn", "dist-mult"):
        head_kwargs["hidden_dims"] = tuple(net_hidden_dims)
    return FixedEmbeddingPredictor(
        head=HEADS[sim_method](name="head", **head_kwargs)
    )


def save_fixed_run(out_dir: str, result: Dict, *, sim_method: str,
                   class_num: int, net_hidden_dims: Tuple[int, ...],
                   table: Dict[str, np.ndarray]) -> None:
    """Write a self-contained fixed-embedding run directory.

    Layout: ``config.json`` (method="fixed" + head config — the marker
    predict.py routes on), ``params.npz`` (train/checkpoints.save_tree,
    no code execution on load — unlike the reference's pickled model,
    mol2vec_predict.py), ``embeddings.npz`` (ids + vectors, so scoring
    needs no external artifact), ``metrics.json``."""
    from gcnbmp_tpu.train.checkpoints import save_tree

    os.makedirs(out_dir, exist_ok=True)
    ids = sorted(table)
    vecs = np.stack([table[i] for i in ids]).astype(np.float32)
    cfg = {
        "method": "fixed",
        "sim_method": sim_method,
        "class_num": int(class_num),
        "net_hidden_dims": list(net_hidden_dims),
        "emb_dim": int(vecs.shape[1]),
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_tree(os.path.join(out_dir, "params.npz"), result["params"])
    np.savez(os.path.join(out_dir, "embeddings.npz"),
             ids=np.asarray(ids), vecs=vecs)
    metrics = {k: result[k] for k in ("train_metrics", "val_metrics", "losses")
               if k in result}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1, default=float)


def is_fixed_run(run_dir: str) -> bool:
    """True when ``run_dir`` is a fixed-embedding run (config.json with
    method == "fixed") — the predict.py routing check (the reference
    keeps a separate script for this, mol2vec_predict.py)."""
    path = os.path.join(run_dir, "config.json")
    try:
        with open(path) as f:
            return json.load(f).get("method") == "fixed"
    except (OSError, ValueError):
        return False


def load_fixed_run(run_dir: str):
    """Load (predictor, params, id->vector table) from save_fixed_run."""
    import jax

    from gcnbmp_tpu.train.checkpoints import load_tree

    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    predictor = _build_fixed_predictor(
        cfg["sim_method"], cfg["class_num"], tuple(cfg["net_hidden_dims"]))
    dummy = jnp.zeros((2, cfg["emb_dim"]), jnp.float32)
    template = predictor.init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    params = load_tree(os.path.join(run_dir, "params.npz"), template)
    data = np.load(os.path.join(run_dir, "embeddings.npz"), allow_pickle=False)
    table = {str(i): v for i, v in zip(data["ids"], data["vecs"])}
    return predictor, params, table


def score_fixed_pairs(run_dir: str, id1, id2,
                      batch_size: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Score id pairs with a fixed-embedding run.

    Returns ``(probs, present)``: sigmoid probabilities for rows whose
    BOTH ids are in the run's embedding table (shape (n_present,) or
    (n_present, class_num)), and the boolean presence mask over the
    input rows (the analog of the graph path's is_successful)."""
    import jax

    predictor, params, table = load_fixed_run(run_dir)
    id1 = [str(x) for x in id1]
    id2 = [str(x) for x in id2]
    present = np.array([a in table and b in table for a, b in zip(id1, id2)])
    if not present.any():
        return np.zeros((0,), np.float32), present
    e1 = np.stack([table[a] for a, ok in zip(id1, present) if ok])
    e2 = np.stack([table[b] for b, ok in zip(id2, present) if ok])

    infer = jax.jit(lambda a, b: predictor.apply({"params": params}, a, b))
    chunks = []
    for s in range(0, len(e1), batch_size):
        logits = np.asarray(infer(jnp.asarray(e1[s:s + batch_size]),
                                  jnp.asarray(e2[s:s + batch_size])))
        chunks.append(logits)
    logits = np.concatenate(chunks)
    if logits.ndim > 1 and logits.shape[-1] == 1:
        logits = logits[:, 0]
    return 1.0 / (1.0 + np.exp(-logits)), present
