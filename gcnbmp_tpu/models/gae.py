"""Graph auto-encoder baseline over the DDI graph itself.

Reference: train_gcn_cos.py:288-600 (TensorFlow 1.x, Decagon/Kipf-GAE
style) — two GraphConvolution layers (hidden 32 -> embedding 16, relu
then linear), symmetric-normalized adjacency with self-loops, inner-
product decoder, weighted cross-entropy with pos_weight, and
masked-edge train/val/test evaluation (mask_test_edges,
train_gcn_cos.py:137).  The multi-relational variant
(train_gcn_cos_multi.py) stacks one decoder per relation.

JAX re-design: the DDI graph is tiny (546 drugs), so the adjacency is a
dense (N, N) matrix and everything is plain jit-compiled matmuls —
no sparse machinery needed at this scale.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from gcnbmp_tpu import nn


def normalize_adj(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 (reference preprocess_graph,
    train_gcn_cos.py:108-115)."""
    a = np.asarray(adj, np.float32)
    a = a + np.eye(a.shape[0], dtype=np.float32)
    d = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    return (a * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]


class GCNEncoder(nn.Module):
    hidden1: int = 32
    hidden2: int = 16
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x, adj_norm, deterministic=True):
        x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        x = nn.relu(adj_norm @ nn.Dense(self.hidden1, use_bias=False,
                                        kernel_init=nn.initializers.glorot_uniform(),
                                        name="gc1")(x))
        x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        z = adj_norm @ nn.Dense(self.hidden2, use_bias=False,
                                kernel_init=nn.initializers.glorot_uniform(),
                                name="gc2")(x)
        return z


class GAE(nn.Module):
    """Encoder + inner-product decoder; returns reconstruction logits."""

    hidden1: int = 32
    hidden2: int = 16
    dropout: float = 0.1
    n_relations: int = 1  # >1 = multi-relational (train_gcn_cos_multi.py)

    @nn.compact
    def __call__(self, x, adj_norm, deterministic=True):
        z = GCNEncoder(self.hidden1, self.hidden2, self.dropout,
                       name="encoder")(x, adj_norm, deterministic)
        if self.n_relations == 1:
            logits = z @ z.T
        else:
            # per-relation diagonal decoder (Decagon-style DEDICOM-lite)
            r = self.param("relation_diag",
                           nn.initializers.ones, (self.n_relations, self.hidden2))
            logits = jnp.einsum("ic,rc,jc->rij", z, r, z)
        return logits, z


def mask_test_edges(
    adj: np.ndarray, val_frac: float = 0.05, test_frac: float = 0.10,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Hold out edges + sample equal negatives (reference mask_test_edges,
    train_gcn_cos.py:137).  Returns train adjacency and edge lists."""
    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    iu = np.triu_indices(n, k=1)
    pos = np.stack([iu[0][adj[iu] > 0], iu[1][adj[iu] > 0]], axis=1)
    perm = rng.permutation(len(pos))
    n_val = int(len(pos) * val_frac)
    n_test = int(len(pos) * test_frac)
    val_pos = pos[perm[:n_val]]
    test_pos = pos[perm[n_val:n_val + n_test]]
    train_pos = pos[perm[n_val + n_test:]]
    # negatives: absent edges
    neg_needed = n_val + n_test
    negs = []
    seen = set(map(tuple, pos))
    while len(negs) < neg_needed:
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        a, b = (i, j) if i < j else (j, i)
        if (a, b) in seen:
            continue
        seen.add((a, b))
        negs.append((a, b))
    negs = np.asarray(negs)
    adj_train = np.zeros_like(adj)
    adj_train[train_pos[:, 0], train_pos[:, 1]] = 1
    adj_train[train_pos[:, 1], train_pos[:, 0]] = 1
    return {
        "adj_train": adj_train,
        "train_pos": train_pos,
        "val_pos": val_pos, "val_neg": negs[:n_val],
        "test_pos": test_pos, "test_neg": negs[n_val:],
    }


def parse_edge_csv(filepath, id2ind: Optional[Dict] = None):
    """Read a pair CSV into (pos_edges, neg_edges) index arrays
    (reference parse_ddi_dataset, train_gcn_cos_multi.py:125-134: rows
    with label==1 are positive edges, label==0 negatives; cid columns
    are mapped through the drug-index map when given)."""
    import pandas as pd

    df = pd.read_csv(filepath)
    cols = ("cid_1", "cid_2") if "cid_1" in df.columns else (
        "drugbank_id_1", "drugbank_id_2")

    def to_ind(rows):
        if id2ind is not None:
            return np.asarray(
                [(id2ind[a], id2ind[b]) for a, b in rows], np.int32
            ).reshape(-1, 2)
        return np.asarray(list(rows), np.int32).reshape(-1, 2)

    pos = df[df["label"] == 1]
    neg = df[df["label"] == 0]
    return (to_ind(zip(pos[cols[0]], pos[cols[1]])),
            to_ind(zip(neg[cols[0]], neg[cols[1]])))


def mask_test_edges_from_splits(
    n: int,
    train_pos: np.ndarray,
    val_pos: np.ndarray, val_neg: np.ndarray,
    test_pos: np.ndarray, test_neg: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Externally-provided split variant of mask_test_edges (reference
    mask_test_edges with train/valid/test_filepath set,
    train_gcn_cos_multi.py:136-175): the train adjacency is rebuilt from
    the given positive train edges and val/test pos+neg lists are used
    as-is — this is how the KAIST multi-class splits drive the GAE."""
    adj_train = np.zeros((n, n), np.float32)
    tp = np.asarray(train_pos, np.int64).reshape(-1, 2)
    adj_train[tp[:, 0], tp[:, 1]] = 1
    adj_train[tp[:, 1], tp[:, 0]] = 1
    return {
        "adj_train": adj_train,
        "train_pos": tp,
        "val_pos": np.asarray(val_pos).reshape(-1, 2),
        "val_neg": np.asarray(val_neg).reshape(-1, 2),
        "test_pos": np.asarray(test_pos).reshape(-1, 2),
        "test_neg": np.asarray(test_neg).reshape(-1, 2),
    }


def train_gae(
    adj: np.ndarray,
    features: Optional[np.ndarray] = None,
    hidden1: int = 32,
    hidden2: int = 16,
    dropout: float = 0.1,
    learning_rate: float = 0.01,
    epochs: int = 200,
    seed: int = 0,
    val_frac: float = 0.05,
    test_frac: float = 0.10,
    splits: Optional[Dict[str, np.ndarray]] = None,
) -> Dict:
    """Full GAE training run; returns embeddings + edge-prediction metrics
    (reference main loop, train_gcn_cos.py:430-600; default hyperparams
    :50-54).  ``splits`` (from mask_test_edges_from_splits) overrides the
    random holdout with externally-provided train/val/test edges — the
    train_gcn_cos_multi.py KAIST workflow."""
    from sklearn import metrics as skm

    n = adj.shape[0]
    masked = (splits if splits is not None
              else mask_test_edges(np.asarray(adj), val_frac, test_frac, seed))
    adj_train = masked["adj_train"]
    adj_norm = jnp.asarray(normalize_adj(adj_train))
    x = jnp.asarray(
        features if features is not None else np.eye(n, dtype=np.float32)
    )
    target = jnp.asarray(
        adj_train + np.eye(n, dtype=np.float32)
    )  # reconstruct edges + self-loops (adj_label, reference :472)
    e = float(adj_train.sum())
    pos_weight = float(n * n - e) / max(e, 1.0)
    norm = n * n / float(2 * max((n * n - e), 1.0))

    model = GAE(hidden1, hidden2, dropout)
    rng = jax.random.PRNGKey(seed)
    variables = model.init(rng, x, adj_norm)
    params = variables["params"]
    tx = optax.adam(learning_rate)
    opt_state = tx.init(params)

    def loss_fn(p, dropout_rng):
        logits, _ = model.apply(
            {"params": p}, x, adj_norm, deterministic=False,
            rngs={"dropout": dropout_rng},
        )
        w = target * pos_weight + (1.0 - target)
        ce = optax.sigmoid_binary_cross_entropy(logits, target) * w
        return norm * jnp.mean(ce)

    @jax.jit
    def step(p, s, key):
        loss, grads = jax.value_and_grad(loss_fn)(p, key)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    for epoch in range(epochs):
        rng, sub = jax.random.split(rng)
        params, opt_state, loss = step(params, opt_state, sub)

    _, z = model.apply({"params": params}, x, adj_norm, deterministic=True)
    z = np.asarray(z)

    def edge_metrics(pos, neg):
        scores = np.concatenate([
            np.sum(z[pos[:, 0]] * z[pos[:, 1]], axis=1),
            np.sum(z[neg[:, 0]] * z[neg[:, 1]], axis=1),
        ])
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        probs = 1 / (1 + np.exp(-scores))
        return {
            "roc_auc": float(skm.roc_auc_score(y, probs)),
            "ap": float(skm.average_precision_score(y, probs)),
        }

    return {
        "embeddings": z,
        "params": params,
        "final_loss": float(loss),
        "val": edge_metrics(masked["val_pos"], masked["val_neg"]),
        "test": edge_metrics(masked["test_pos"], masked["test_neg"]),
    }
