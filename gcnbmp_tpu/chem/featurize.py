"""SMILES -> numeric graph features.

Implements the reference's three preprocessor families over the
backend-free ``Mol`` model:

- ``GGNNFeaturizer`` (canonical path): atom-ID array + 4-channel one-hot
  bond-type adjacency.  Default ``mode='atomic_number'`` matches
  chainer_chemistry's GGNNPreprocessor (construct_atomic_number_array +
  construct_discrete_edge_matrix) used by the flagship training script
  (reference: train_ddi_modify_eval2.py:489-492).  ``mode='wl'`` matches
  MyGGNNPreprocessor's dataset-built WL/r-radius subgraph vocabulary
  (reference: my_utils/preprocessors/ggnn_preprocessor.py:81-146).
- ``DrugFPFeaturizer``: dense 66-dim per-atom features (44-symbol one-hot
  + degree/numH/valence one-hots + aromatic flag; reference:
  my_utils/preprocessors/drugfp_preprocessor.py:30-40) + the same
  adjacency.
- ``NFPFeaturizer`` lives in the models layer (degree-conditioned, needs
  no extra chemistry here).

Outputs are ragged per-molecule numpy arrays; batching/padding/packing is
the data layer's job (static shapes are produced there, not here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from gcnbmp_tpu.chem.mol import BondOrder, Mol

NUM_EDGE_TYPES = 4
# chainer_chemistry.config.MAX_ATOMIC_NUM — embedding vocab of the
# reference's EmbedAtomID (reference: models/ggnn.py:14,87).
MAX_ATOMIC_NUM = 117

DRUGFP_SYMBOLS = [
    "C", "N", "O", "S", "F", "Si", "P", "Cl", "Br", "Mg", "Na",
    "Ca", "Fe", "As", "Al", "I", "B", "V", "K", "Tl", "Yb",
    "Sb", "Sn", "Ag", "Pd", "Co", "Se", "Ti", "Zn", "H",
    "Li", "Ge", "Cu", "Au", "Ni", "Cd", "In", "Mn", "Zr",
    "Cr", "Pt", "Hg", "Pb", "Unknown",
]
DRUGFP_DEGREES = [0, 1, 2, 3, 4, 5, 6]
DRUGFP_NUM_FEATURES = len(DRUGFP_SYMBOLS) + 3 * len(DRUGFP_DEGREES) + 1  # 66


class FeaturizeError(ValueError):
    pass


@dataclass
class MolGraph:
    """Ragged featurized molecule.

    ``atom_ids``: int32[N] (or -1s when dense features are used);
    ``atom_feats``: optional float32[N, F];
    ``edge_src``/``edge_dst``/``edge_type``: int32[E*2] directed edges
    (both directions materialized — the adjacency is symmetric);
    """

    atom_ids: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_type: np.ndarray
    atom_feats: Optional[np.ndarray] = None
    pair_feats: Optional[np.ndarray] = None  # (N, N, F) Weave pair features
    smiles: str = ""

    @property
    def num_atoms(self) -> int:
        return int(self.atom_ids.shape[0])

    @property
    def num_edges(self) -> int:
        """Directed edge count (2x bond count)."""
        return int(self.edge_src.shape[0])

    def dense_adj(self, out_size: Optional[int] = None) -> np.ndarray:
        """(4, N, N) one-hot bond-type adjacency, float32.

        Matches chainer_chemistry's construct_discrete_edge_matrix: both
        directions set to 1, channel = bond type, zero diagonal.
        """
        n = self.num_atoms if out_size is None else out_size
        adj = np.zeros((NUM_EDGE_TYPES, n, n), dtype=np.float32)
        adj[self.edge_type, self.edge_src, self.edge_dst] = 1.0
        return adj


def _edges_from_mol(mol: Mol) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    e = mol.num_bonds
    src = np.empty(2 * e, dtype=np.int32)
    dst = np.empty(2 * e, dtype=np.int32)
    typ = np.empty(2 * e, dtype=np.int32)
    for i, b in enumerate(mol.bonds):
        src[2 * i], dst[2 * i], typ[2 * i] = b.a1, b.a2, int(b.order)
        src[2 * i + 1], dst[2 * i + 1], typ[2 * i + 1] = b.a2, b.a1, int(b.order)
    return src, dst, typ


@dataclass
class GGNNFeaturizer:
    """Featurizer for the GGNN/RelGCN/GIN/MPNN encoder family.

    Args:
        mode: 'atomic_number' -> atom IDs are atomic numbers (canonical);
            'wl' -> WL r-radius subgraph IDs from a growing vocabulary.
        radius: WL radius ('wl' mode); radius=0 => (symbol, aromatic) IDs.
        max_atoms: molecules with more atoms raise FeaturizeError
            (mirrors type_check_num_atoms); negative = unlimited.
        out_size: pad atom/adj arrays to this size per molecule
            (negative = no per-molecule padding; the batcher pads).
    """

    mode: str = "atomic_number"
    radius: int = 0
    max_atoms: int = -1
    out_size: int = -1
    add_hs: bool = False     # materialize implicit H atoms (MolPreprocessor add_Hs)
    kekulize: bool = False   # replace aromatic bonds by alternating S/D
    # WL vocabularies, built on the fly like the reference's defaultdicts.
    atom_vocab: Dict = field(default_factory=dict)
    fp_vocab: Dict = field(default_factory=dict)
    edge_vocab: Dict = field(default_factory=dict)

    def _vocab_id(self, vocab: Dict, key) -> int:
        if key not in vocab:
            vocab[key] = len(vocab)
        return vocab[key]

    def _wl_ids(self, mol: Mol) -> np.ndarray:
        atoms = []
        for a in mol.atoms:
            key = (a.symbol, "aromatic") if a.aromatic else a.symbol
            atoms.append(self._vocab_id(self.atom_vocab, key))
        if mol.num_atoms == 1 or self.radius == 0:
            fps = [self._vocab_id(self.fp_vocab, a) for a in atoms]
            return np.asarray(fps, dtype=np.int32)
        # r-radius WL refinement over (node id, sorted neighbor (id, edge))
        nodes = atoms
        edge_ids = {bi: self._vocab_id(self.edge_vocab, ("bond", int(b.order)))
                    for bi, b in enumerate(mol.bonds)}
        for _ in range(self.radius):
            fps = []
            for i in range(mol.num_atoms):
                neighbors = tuple(
                    sorted((nodes[j], edge_ids[bi]) for j, bi in mol.neighbors(i))
                )
                fps.append(self._vocab_id(self.fp_vocab, (nodes[i], neighbors)))
            new_edge_ids = {}
            for bi, b in enumerate(mol.bonds):
                both = tuple(sorted((fps[b.a1], fps[b.a2])))
                new_edge_ids[bi] = self._vocab_id(self.edge_vocab, (both, edge_ids[bi]))
            nodes, edge_ids = fps, new_edge_ids
        return np.asarray(nodes, dtype=np.int32)

    def __call__(self, mol: Mol) -> MolGraph:
        if self.add_hs or self.kekulize:
            from gcnbmp_tpu.chem.transforms import (
                add_explicit_hydrogens,
                kekulize as kekulize_fn,
            )

            if self.kekulize:
                kek = kekulize_fn(mol)
                if kek is None:
                    raise FeaturizeError(f"cannot kekulize {mol.smiles!r}")
                mol = kek
            if self.add_hs:
                mol = add_explicit_hydrogens(mol)
        n = mol.num_atoms
        if 0 <= self.max_atoms < n:
            raise FeaturizeError(
                f"molecule has {n} atoms > max_atoms={self.max_atoms}"
            )
        if self.mode == "atomic_number":
            ids = np.asarray([a.atomic_num for a in mol.atoms], dtype=np.int32)
        elif self.mode == "wl":
            ids = self._wl_ids(mol)
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        src, dst, typ = _edges_from_mol(mol)
        if self.out_size >= 0:
            if self.out_size < n:
                raise FeaturizeError(
                    f"out_size={self.out_size} < num_atoms={n}"
                )
            ids = np.pad(ids, (0, self.out_size - n))
        return MolGraph(
            atom_ids=ids, edge_src=src, edge_dst=dst, edge_type=typ,
            smiles=mol.smiles,
        )


def _one_hot(value, allowable, unk_last: bool) -> List[float]:
    if value not in allowable:
        if not unk_last:
            raise FeaturizeError(f"{value!r} not in {allowable}")
        value = allowable[-1]
    return [1.0 if value == a else 0.0 for a in allowable]


def drugfp_atom_features(mol: Mol, idx: int) -> np.ndarray:
    """66-dim feature vector (reference: drugfp_preprocessor.py:30-40)."""
    a = mol.atoms[idx]
    feats = (
        _one_hot(a.symbol, DRUGFP_SYMBOLS, unk_last=True)
        + _one_hot(mol.degree(idx), DRUGFP_DEGREES, unk_last=False)
        + _one_hot(a.total_h, DRUGFP_DEGREES, unk_last=True)
        + _one_hot(a.total_h, DRUGFP_DEGREES, unk_last=True)  # implicit valence
        + [1.0 if a.aromatic else 0.0]
    )
    return np.asarray(feats, dtype=np.float32)


def _ring_bond_set(mol: Mol) -> set:
    # cached per Mol: recomputing per bond made the per-bond feature API
    # O(B * (N + B)) instead of O(N + B)
    cached = getattr(mol, "_ring_bond_cache", None)
    if cached is not None:
        return cached
    ring_bonds = set()
    for ring in mol.ring_info():
        rs = set(ring)
        for a in ring:
            for w, bi in mol.neighbors(a):
                if w in rs:
                    ring_bonds.add(bi)
    mol._ring_bond_cache = ring_bonds
    return ring_bonds


def drugfp_bond_features(mol: Mol, bond_idx: int) -> np.ndarray:
    """6-dim bond features (reference: drugfp_preprocessor.py:43-50).

    Conjugation is approximated (no RDKit): a bond counts as conjugated if
    it is aromatic, or if both end atoms carry some other multiple-order/
    aromatic bond (covers alternating single/double chains).
    """
    b = mol.bonds[bond_idx]

    def _end_conjugating(atom_idx: int) -> bool:
        return any(
            bi != bond_idx
            and mol.bonds[bi].order in (BondOrder.DOUBLE, BondOrder.TRIPLE, BondOrder.AROMATIC)
            for _, bi in mol.neighbors(atom_idx)
        )

    conjugated = b.order == BondOrder.AROMATIC or (
        _end_conjugating(b.a1) and _end_conjugating(b.a2)
    )
    in_ring = bond_idx in _ring_bond_set(mol)
    return np.asarray(
        [
            1.0 if b.order == BondOrder.SINGLE else 0.0,
            1.0 if b.order == BondOrder.DOUBLE else 0.0,
            1.0 if b.order == BondOrder.TRIPLE else 0.0,
            1.0 if b.order == BondOrder.AROMATIC else 0.0,
            1.0 if conjugated else 0.0,
            1.0 if in_ring else 0.0,
        ],
        dtype=np.float32,
    )


WEAVE_HYBRIDIZATIONS = ["SP", "SP2", "SP3", "other"]


def _hybridization(mol: Mol, idx: int) -> str:
    """Approximate hybridization from bond orders (no RDKit):
    triple or two doubles -> SP; any double/aromatic -> SP2; else SP3."""
    doubles = triples = aroms = 0
    for _, bi in mol.neighbors(idx):
        o = mol.bonds[bi].order
        if o == BondOrder.DOUBLE:
            doubles += 1
        elif o == BondOrder.TRIPLE:
            triples += 1
        elif o == BondOrder.AROMATIC:
            aroms += 1
    if triples or doubles >= 2:
        return "SP"
    if doubles or aroms:
        return "SP2"
    return "SP3"


def weave_atom_features(mol: Mol, idx: int) -> np.ndarray:
    """75-dim deepchem-Weave-style per-atom features (reference:
    graph_features.py atom_features:122-199 — 44 symbols + 11 degree +
    7 implicit valence + charge + radical + 5 hybridization + aromatic +
    5 H count; hybridization approximated, radicals always 0 here)."""
    a = mol.atoms[idx]
    feats = _one_hot(a.symbol, DRUGFP_SYMBOLS, unk_last=True)             # 44
    feats += _one_hot(min(mol.degree(idx), 10), list(range(11)), True)    # 11
    feats += _one_hot(min(a.total_h, 6), list(range(7)), True)            # 7
    feats += [float(a.charge), 0.0]                                       # 2
    feats += _one_hot(_hybridization(mol, idx),
                      WEAVE_HYBRIDIZATIONS + ["x"], True)[:5]             # 5
    feats += [1.0 if a.aromatic else 0.0]                                 # 1
    feats += _one_hot(min(a.total_h, 4), list(range(5)), True)            # 5
    return np.asarray(feats, dtype=np.float32)  # 75


def weave_pair_features(mol: Mol, max_distance: int = 7) -> np.ndarray:
    """(N, N, 14) pair features (reference: graph_features.py
    WeaveFeaturizer:385 / pair_features): bond-type one-hot (4) +
    graph-distance one-hot (<= max_distance, 7) + same-ring flag ...
    padded to 14."""
    n = mol.num_atoms
    out = np.zeros((n, n, 14), np.float32)
    for b in mol.bonds:
        out[b.a1, b.a2, int(b.order)] = 1.0
        out[b.a2, b.a1, int(b.order)] = 1.0
    # BFS graph distances
    for src in range(n):
        dist = {src: 0}
        frontier = [src]
        while frontier:
            nxt = []
            for v in frontier:
                for w, _ in mol.neighbors(v):
                    if w not in dist:
                        dist[w] = dist[v] + 1
                        nxt.append(w)
            frontier = nxt
        for dst, d in dist.items():
            if 1 <= d <= max_distance:
                out[src, dst, 3 + d] = 1.0  # channels 4..10
    ring_atom_sets = [set(r) for r in mol.ring_info()]
    for rs in ring_atom_sets:
        for i in rs:
            for j in rs:
                if i != j:
                    out[i, j, 11] = 1.0  # same-ring
    return out


@dataclass
class WeaveFeaturizer:
    """ConvMol/Weave-style featurizer: dense 75-dim atom features +
    bond-type adjacency (+ optional pair features)."""

    max_atoms: int = -1
    with_pair_features: bool = False

    def __call__(self, mol: Mol) -> MolGraph:
        n = mol.num_atoms
        if 0 <= self.max_atoms < n:
            raise FeaturizeError(f"{n} atoms > max_atoms={self.max_atoms}")
        feats = np.stack([weave_atom_features(mol, i) for i in range(n)])
        src, dst, typ = _edges_from_mol(mol)
        return MolGraph(
            atom_ids=np.full((n,), -1, dtype=np.int32),
            edge_src=src, edge_dst=dst, edge_type=typ,
            atom_feats=feats,
            pair_feats=weave_pair_features(mol) if self.with_pair_features else None,
            smiles=mol.smiles,
        )


@dataclass
class DrugFPFeaturizer:
    """Dense per-atom feature matrix + bond-type adjacency

    (reference: DrugFPPreprocessor.get_input_features,
    my_utils/preprocessors/drugfp_preprocessor.py:146-158)."""

    max_atoms: int = -1
    out_size: int = -1

    def __call__(self, mol: Mol) -> MolGraph:
        n = mol.num_atoms
        if 0 <= self.max_atoms < n:
            raise FeaturizeError(
                f"molecule has {n} atoms > max_atoms={self.max_atoms}"
            )
        feats = np.stack([drugfp_atom_features(mol, i) for i in range(n)])
        src, dst, typ = _edges_from_mol(mol)
        if self.out_size >= 0:
            if self.out_size < n:
                raise FeaturizeError(f"out_size={self.out_size} < {n}")
            feats = np.pad(feats, ((0, self.out_size - n), (0, 0)))
        return MolGraph(
            atom_ids=np.full((feats.shape[0],), -1, dtype=np.int32),
            edge_src=src, edge_dst=dst, edge_type=typ,
            atom_feats=feats, smiles=mol.smiles,
        )
