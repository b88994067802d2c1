"""Pair datasets and static-shape batching.

Replaces the reference's NumpyTupleDataset + chainer_chemistry
``concat_mols`` pad-to-max converter (reference: parsers.py:28-121,
train_ddi_modify_eval2.py:556-590).  Differences:

- padding targets come from a fixed bucket ladder, so jit sees a small,
  closed set of shapes instead of one shape per batch;
- batches carry an explicit node mask (the reference leaves padded atoms
  "live" through the readout — see PairPredictor's ``mask_padding`` flag
  for the parity switch);
- a packed "supergraph" layout (many molecules bin-packed into fixed
  128-atom tiles) is provided for the high-throughput path (see
  ``gcnbmp_tpu.data.packing``).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gcnbmp_tpu.chem.featurize import MolGraph, NUM_EDGE_TYPES

# Bucket ladder for per-batch padded atom counts.  Drug molecules are
# ≲100 atoms; the top bucket handles outliers.
DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 160, 256)


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / 128) * 128)


@dataclass
class PaddedPairBatch:
    """One padded minibatch of molecule pairs (a pytree of numpy/jax arrays).

    Shapes: atoms (B, N) int32 (pad id 0 — matches concat_mols), adj
    (B, 4, N, N) float32, mask (B, N) float32, labels (B,) or (B, C).
    ``atom_feats`` replaces ``atoms`` for dense-featurized inputs.
    """

    atoms1: np.ndarray
    adj1: np.ndarray
    mask1: np.ndarray
    atoms2: np.ndarray
    adj2: np.ndarray
    mask2: np.ndarray
    labels: np.ndarray
    atom_feats1: Optional[np.ndarray] = None
    atom_feats2: Optional[np.ndarray] = None
    super1: Optional[np.ndarray] = None  # (B, F_s) supernode features (GWM)
    super2: Optional[np.ndarray] = None
    n_edges: Optional[int] = None  # precomputed by make_batch

    @property
    def batch_size(self) -> int:
        return int(self.atoms1.shape[0])

    @property
    def num_edges(self) -> int:
        """Total directed edges in the batch (both molecules).
        Precomputed from graph metadata at batch build (summing the
        dense adjacency host-side costs ~10s of ms/step at B=2048)."""
        if self.n_edges is not None:
            return self.n_edges
        return int(self.adj1.sum() + self.adj2.sum())


def pad_graphs(
    graphs: Sequence[MolGraph], n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Pad a list of ragged graphs to (B, n) / (B, 4, n, n) / mask."""
    b = len(graphs)
    atoms = np.zeros((b, n), dtype=np.int32)
    adj = np.zeros((b, NUM_EDGE_TYPES, n, n), dtype=np.float32)
    mask = np.zeros((b, n), dtype=np.float32)
    feats = None
    if graphs and graphs[0].atom_feats is not None:
        f = graphs[0].atom_feats.shape[-1]
        feats = np.zeros((b, n, f), dtype=np.float32)
    for i, g in enumerate(graphs):
        k = g.num_atoms
        if k > n:
            raise ValueError(f"graph with {k} atoms does not fit pad size {n}")
        atoms[i, :k] = g.atom_ids
        adj[i, g.edge_type, g.edge_src, g.edge_dst] = 1.0
        mask[i, :k] = 1.0
        if feats is not None:
            feats[i, :k] = g.atom_feats
    return atoms, adj, mask, feats


@dataclass
class PairDataset:
    """In-memory dataset of (mol graph, mol graph, label) triples.

    Mirrors the 5-tuple NumpyTupleDataset of the reference
    (parsers.py:319) plus SMILES bookkeeping.
    """

    graphs1: List[MolGraph] = field(default_factory=list)
    graphs2: List[MolGraph] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    smiles_pairs: List[Tuple[str, str]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i):
        return self.graphs1[i], self.graphs2[i], self.labels[i]

    def append(self, g1: MolGraph, g2: MolGraph, label) -> None:
        self.graphs1.append(g1)
        self.graphs2.append(g2)
        self.labels.append(np.asarray(label))
        self.smiles_pairs.append((g1.smiles, g2.smiles))

    def subset(self, indices: Iterable[int]) -> "PairDataset":
        idx = list(indices)
        return PairDataset(
            graphs1=[self.graphs1[i] for i in idx],
            graphs2=[self.graphs2[i] for i in idx],
            labels=[self.labels[i] for i in idx],
            smiles_pairs=[self.smiles_pairs[i] for i in idx],
        )

    def augment_swap(self) -> "PairDataset":
        """Double the dataset with (mol2, mol1) copies

        (reference: train_ddi_modify_eval2.py:317-326)."""
        out = PairDataset(
            graphs1=self.graphs1 + self.graphs2,
            graphs2=self.graphs2 + self.graphs1,
            labels=self.labels + self.labels,
            smiles_pairs=self.smiles_pairs + [(b, a) for a, b in self.smiles_pairs],
        )
        return out

    def rebalance(
        self, rng: np.random.Generator, ratio: float = 1.0
    ) -> "PairDataset":
        """Subsample to a pos:neg ratio (default 1:1 = the reference's
        balance option, train_ddi_modify_eval2.py:525-551; other ratios
        cover utils.py split_dataset_imbalance)."""
        labels = np.asarray([float(np.ravel(l)[0]) for l in self.labels])
        pos = np.flatnonzero(labels > 0.5)
        neg = np.flatnonzero(labels <= 0.5)
        k_pos = min(len(pos), int(len(neg) * ratio))
        k_neg = min(len(neg), int(np.ceil(k_pos / ratio)))
        keep = np.concatenate(
            [rng.choice(pos, k_pos, replace=False),
             rng.choice(neg, k_neg, replace=False)]
        )
        rng.shuffle(keep)
        return self.subset(keep.tolist())

    def max_atoms(self) -> int:
        m = 0
        for g in self.graphs1:
            m = max(m, g.num_atoms)
        for g in self.graphs2:
            m = max(m, g.num_atoms)
        return m

    def label_array(self) -> np.ndarray:
        return np.stack([np.atleast_1d(l) for l in self.labels])

    def save(self, path: str) -> None:
        """Pickle cache (reference: data_pipeline.py:20-100)."""
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "PairDataset":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, PairDataset):
            raise TypeError(f"{path} does not contain a PairDataset")
        return obj


def make_batch(
    ds: PairDataset,
    indices: Sequence[int],
    pad_to: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    fill_batch_to: Optional[int] = None,
    supernode_fn=None,
) -> PaddedPairBatch:
    """Build one padded batch.

    ``supernode_fn``: optional SMILES -> feature-vector callable; fills
    the batch's super1/super2 for the GWM encoder (reference supernode
    plumbing, train_ggnn_hole_with_gwm.py:321-347).

    ``fill_batch_to``: pad a short batch up to this many rows with empty
    graphs and label ``-1`` (ignored by the loss and filtered by metric
    collection) — keeps the jit shape set closed, so each shape compiles
    once.
    """
    g1 = [ds.graphs1[i] for i in indices]
    g2 = [ds.graphs2[i] for i in indices]
    label_rows = [np.atleast_1d(ds.labels[i]).astype(np.float32) for i in indices]
    n_fill = 0
    if fill_batch_to is not None and len(indices) < fill_batch_to:
        n_fill = fill_batch_to - len(indices)
        empty = MolGraph(
            atom_ids=np.zeros((1,), dtype=np.int32),
            edge_src=np.zeros((0,), dtype=np.int32),
            edge_dst=np.zeros((0,), dtype=np.int32),
            edge_type=np.zeros((0,), dtype=np.int32),
        )
        g1 = g1 + [empty] * n_fill
        g2 = g2 + [empty] * n_fill
        label_rows = label_rows + [np.full_like(label_rows[0], -1.0)] * n_fill
    n = pad_to
    if n is None:
        raw = max(max(g.num_atoms for g in g1), max(g.num_atoms for g in g2))
        n = bucket_size(raw, buckets)
    a1, adj1, m1, f1 = pad_graphs(g1, n)
    a2, adj2, m2, f2 = pad_graphs(g2, n)
    labels = np.stack(label_rows)
    if labels.shape[-1] == 1:
        labels = labels[:, 0]
    s1 = s2 = None
    if supernode_fn is not None:
        def snode(graphs):
            rows = [
                np.asarray(supernode_fn(g.smiles), np.float32) if g.smiles else None
                for g in graphs
            ]
            dim = next(len(r) for r in rows if r is not None)
            return np.stack([
                r if r is not None else np.zeros((dim,), np.float32) for r in rows
            ])

        s1, s2 = snode(g1), snode(g2)
    return PaddedPairBatch(
        atoms1=a1, adj1=adj1, mask1=m1,
        atoms2=a2, adj2=adj2, mask2=m2,
        labels=labels, atom_feats1=f1, atom_feats2=f2,
        super1=s1, super2=s2,
        n_edges=int(sum(g.num_edges for g in g1)
                    + sum(g.num_edges for g in g2)),
    )


def batch_iterator(
    ds: PairDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    rng: Optional[np.random.Generator] = None,
    pad_to: Optional[int] = None,
    drop_remainder: bool = False,
    repeat: bool = False,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    fill_last: bool = True,
    supernode_fn=None,
) -> Iterator[PaddedPairBatch]:
    """SerialIterator + concat_mols equivalent.

    The last short batch is filled to ``batch_size`` with ignore-label
    rows (``fill_last``, default) so every batch has the same shape —
    one jit compilation per (batch, pad) pair instead of one per epoch
    tail.  ``drop_remainder`` skips the tail entirely instead.
    """
    n = len(ds)
    rng = rng or np.random.default_rng(0)
    while True:
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size and drop_remainder:
                continue
            yield make_batch(
                ds, idx.tolist(), pad_to=pad_to, buckets=buckets,
                fill_batch_to=batch_size if fill_last else None,
                supernode_fn=supernode_fn,
            )
        if not repeat:
            break
