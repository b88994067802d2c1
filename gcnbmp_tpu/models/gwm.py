"""GGNN with Graph Warp Module (supernode exchange).

Reference: models/ggnn_gwm.py:13-132 — GGNN updates plus the
chainer_chemistry GWM (Ishiguro, Maeda, Koyama: "Graph Warp Module",
arXiv 2019): a per-molecule supernode exchanges information with the
atom nodes every layer through transmitter units (multi-head attention
node->super, broadcast super->node), warp gates, and two GRUs.  The
final readout concatenates the gated graph readout with the supernode
state through a ReLU linear (reference :123-131).

The GWM internals follow the cited paper (the chainer_chemistry
implementation is an external dependency not present in the reference
tree, SURVEY §2.8).

Supernode input features (reference data_generator.py:56-121): either
sum/mean/max-pooled per-atom descriptors padded to ``n_super_feature``
(add_super_nodes) or the mean of fixed random per-element embeddings
(add_super_nodes2) — both provided in ``supernode_features`` /
``supernode_features_random``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from gcnbmp_tpu import nn

from gcnbmp_tpu.chem.featurize import drugfp_atom_features
from gcnbmp_tpu.chem.mol import Mol
from gcnbmp_tpu.models.ggnn import GGNNMessage
from gcnbmp_tpu.models.layers import (
    ChainerGRUCell,
    EmbedAtomID,
    LecunNormal,
    MAX_ATOMIC_NUM,
)
from gcnbmp_tpu.models.readouts import CommonGGNNReadout

DEFAULT_N_SUPER_FEATURE = 2 + 2 * 4 + MAX_ATOMIC_NUM * 2  # reference default


class GWMStep(nn.Module):
    """One warp step: (h, h2, h_s) -> (merged_local, merged_super).

    h: pre-update node states, h2: GNN-updated node states,
    h_s: supernode state.
    """

    hidden_dim: int
    hidden_dim_super: int
    n_heads: int = 8

    @nn.compact
    def __call__(self, h, h2, h_s, mask=None):
        d, ds, k = self.hidden_dim, self.hidden_dim_super, self.n_heads
        dense = lambda f, name: nn.Dense(f, kernel_init=LecunNormal(), name=name)
        # --- transmitter: local -> super (multi-head attention) ---
        q = jnp.tanh(dense(k * d, "super_query")(h_s))  # (B, k*d)
        keys = jnp.tanh(dense(k * d, "local_key")(h))   # (B, N, k*d)
        b, n, _ = h.shape
        qh = q.reshape(b, 1, k, d)
        kh = keys.reshape(b, n, k, d)
        scores = jnp.einsum("bnkd,bokd->bnk", kh, qh) / jnp.sqrt(float(d))
        if mask is not None:
            scores = jnp.where(mask[..., None] > 0, scores, -1e9)
        attn = jax.nn.softmax(scores, axis=1)  # (B, N, k)
        if mask is not None:
            attn = attn * mask[..., None]
        heads = jnp.einsum("bnk,bnd->bkd", attn, h).reshape(b, k * d)
        trans_super = jnp.tanh(dense(ds, "local_to_super")(heads))  # (B, ds)
        # --- transmitter: super -> local (broadcast) ---
        trans_local = jnp.tanh(dense(d, "super_to_local")(h_s))[:, None, :]
        trans_local = jnp.broadcast_to(trans_local, h2.shape)
        # --- warp gates ---
        z_local = jax.nn.sigmoid(
            dense(d, "gate_local_self")(h2) + dense(d, "gate_local_trans")(trans_local)
        )
        merged_local = z_local * trans_local + (1.0 - z_local) * h2
        self_super = dense(ds, "super_self")(h_s)
        z_super = jax.nn.sigmoid(
            dense(ds, "gate_super_self")(h_s) + dense(ds, "gate_super_trans")(trans_super)
        )
        merged_super = z_super * trans_super + (1.0 - z_super) * jnp.tanh(self_super)
        return merged_local, merged_super


class GGNN_GWM(nn.Module):
    """GGNN encoder + Graph Warp Module.

    __call__(atoms, adj, super_node (B, F_s), mask) -> (g, aux)."""

    out_dim: int
    hidden_dim: int = 16
    hidden_dim_super: int = 16
    n_layers: int = 4
    n_heads: int = 8
    n_atom_types: int = MAX_ATOMIC_NUM
    dropout_ratio: float = 0.0
    concat_hidden: bool = False
    weight_tying: bool = True

    @nn.compact
    def __call__(
        self,
        atoms: jnp.ndarray,
        adj: jnp.ndarray,
        super_node: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, Dict[str, Any]]:
        if jnp.issubdtype(atoms.dtype, jnp.integer):
            h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atoms)
        else:
            h = atoms
        h0 = h
        h_s = nn.Dense(self.hidden_dim_super, kernel_init=LecunNormal(),
                       name="embed_super")(super_node)

        n_message = 1 if self.weight_tying else self.n_layers
        messages = [
            GGNNMessage(self.hidden_dim, name=f"update_{i}") for i in range(n_message)
        ]
        gwm_steps = [
            GWMStep(self.hidden_dim, self.hidden_dim_super, self.n_heads,
                    name=f"gwm_{i}")
            for i in range(n_message)
        ]
        pre_updates = [
            nn.Dense(self.hidden_dim, kernel_init=LecunNormal(),
                     name=f"pre_update_{i}")
            for i in range(n_message)
        ]
        gru_local = ChainerGRUCell(self.hidden_dim, name="gru_local")
        gru_super = ChainerGRUCell(self.hidden_dim_super, name="gru_super")
        n_readout = self.n_layers if self.concat_hidden else 1
        readouts = [
            CommonGGNNReadout(self.out_dim, name=f"readout_{i}")
            for i in range(n_readout)
        ]

        state_local = jnp.zeros_like(h)
        state_super = jnp.zeros_like(h_s)
        g_list = []
        for step in range(self.n_layers):
            idx = 0 if self.weight_tying else step
            m = messages[idx](h, adj)
            h2 = pre_updates[idx](jnp.concatenate([h, m], axis=-1))
            merged_local, merged_super = gwm_steps[idx](h, h2, h_s, mask)
            if self.dropout_ratio > 0.0:
                merged_local = nn.Dropout(
                    rate=self.dropout_ratio, deterministic=deterministic
                )(merged_local)
            state_local = gru_local(state_local, merged_local)
            state_super = gru_super(state_super, merged_super)
            h, h_s = state_local, state_super
            if self.concat_hidden:
                g_list.append(readouts[step](h, h0, mask))

        aux = {"atoms": h, "h0": h0, "super": h_s, "h_list": [], "g_list": g_list}
        if self.concat_hidden:
            return jnp.concatenate(g_list, axis=-1), aux
        g = readouts[0](h, h0, mask)
        g2 = jnp.concatenate([g, h_s], axis=-1)
        out = nn.relu(
            nn.Dense(self.out_dim, kernel_init=LecunNormal(),
                     name="linear_for_concat_super")(g2)
        )
        return out, aux


class PackedGWMStep(nn.Module):
    """Packed twin of GWMStep: the node->super multi-head attention
    becomes a segment-softmax over mol_id; per-molecule tensors (the
    supernode side) are (num_mols, ·) instead of (B, ·).  Param names
    match GWMStep exactly so weights swap freely between layouts."""

    hidden_dim: int
    hidden_dim_super: int
    n_heads: int = 8

    @nn.compact
    def __call__(self, h, h2, h_s, mol_id, node_mask, num_mols: int):
        from gcnbmp_tpu.models.packed import segment_softmax

        d, ds, k = self.hidden_dim, self.hidden_dim_super, self.n_heads
        dense = lambda f, name: nn.Dense(f, kernel_init=LecunNormal(), name=name)
        p, t, _ = h.shape
        ids = mol_id.reshape(-1)
        valid = node_mask.reshape(-1)
        # --- transmitter: local -> super (multi-head attention) ---
        q = jnp.tanh(dense(k * d, "super_query")(h_s))     # (M, k*d)
        keys = jnp.tanh(dense(k * d, "local_key")(h))      # (P, T, k*d)
        kh = keys.reshape(p * t, k, d)
        qh = jnp.concatenate(
            [q.reshape(num_mols, k, d), jnp.zeros((1, k, d), q.dtype)], axis=0
        )[ids]  # (N, k, d) — this node's molecule query (pads -> zero row)
        scores = jnp.sum(kh * qh, axis=-1) / jnp.sqrt(float(d))  # (N, k)
        attn = segment_softmax(scores, ids, valid, num_mols + 1)  # (N, k)
        h_flat = h.reshape(p * t, d)
        contrib = (attn[:, :, None] * h_flat[:, None, :]).reshape(p * t, k * d)
        heads = jax.ops.segment_sum(
            contrib, ids, num_segments=num_mols + 1
        )[:num_mols]  # (M, k*d)
        trans_super = jnp.tanh(dense(ds, "local_to_super")(heads))
        # --- transmitter: super -> local (broadcast via gather) ---
        tl = jnp.tanh(dense(d, "super_to_local")(h_s))  # (M, d)
        tl = jnp.concatenate([tl, jnp.zeros((1, d), tl.dtype)], axis=0)
        trans_local = tl[mol_id]  # (P, T, d)
        # --- warp gates ---
        z_local = jax.nn.sigmoid(
            dense(d, "gate_local_self")(h2)
            + dense(d, "gate_local_trans")(trans_local)
        )
        merged_local = z_local * trans_local + (1.0 - z_local) * h2
        self_super = dense(ds, "super_self")(h_s)
        z_super = jax.nn.sigmoid(
            dense(ds, "gate_super_self")(h_s)
            + dense(ds, "gate_super_trans")(trans_super)
        )
        merged_super = z_super * trans_super + (1.0 - z_super) * jnp.tanh(self_super)
        return merged_local, merged_super


class PackedGGNN_GWM(nn.Module):
    """GGNN+GWM forward over packed tiles: the per-molecule supernode
    rides a (num_mols, ds) table exchanged with the packed node states
    through segment ops (VERDICT r1 #3 — the GWM packed fast-path twin).
    Param tree matches GGNN_GWM exactly, so the padded evaluators work on
    packed-trained params."""

    out_dim: int
    hidden_dim: int = 16
    hidden_dim_super: int = 16
    n_layers: int = 4
    n_heads: int = 8
    n_atom_types: int = MAX_ATOMIC_NUM
    dropout_ratio: float = 0.0
    weight_tying: bool = True

    @nn.compact
    def __call__(self, atom_ids, adj, supers, mol_id, node_mask,
                 num_mols: int):
        from gcnbmp_tpu.models.packed import (
            PackedCommonReadout,
            _segment_mol_sum,
        )

        if self.dropout_ratio > 0:
            raise ValueError("packed GWM path supports dropout_ratio=0 only")
        h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atom_ids)
        h0 = h
        h_s = nn.Dense(self.hidden_dim_super, kernel_init=LecunNormal(),
                       name="embed_super")(supers)
        n_message = 1 if self.weight_tying else self.n_layers
        messages = [
            GGNNMessage(self.hidden_dim, name=f"update_{i}")
            for i in range(n_message)
        ]
        gwm_steps = [
            PackedGWMStep(self.hidden_dim, self.hidden_dim_super,
                          self.n_heads, name=f"gwm_{i}")
            for i in range(n_message)
        ]
        pre_updates = [
            nn.Dense(self.hidden_dim, kernel_init=LecunNormal(),
                     name=f"pre_update_{i}")
            for i in range(n_message)
        ]
        gru_local = ChainerGRUCell(self.hidden_dim, name="gru_local")
        gru_super = ChainerGRUCell(self.hidden_dim_super, name="gru_super")

        state_local = jnp.zeros_like(h)
        state_super = jnp.zeros_like(h_s)
        for step in range(self.n_layers):
            idx = 0 if self.weight_tying else step
            m = messages[idx](h, adj)
            h2 = pre_updates[idx](jnp.concatenate([h, m], axis=-1))
            merged_local, merged_super = gwm_steps[idx](
                h, h2, h_s, mol_id, node_mask, num_mols
            )
            state_local = gru_local(state_local, merged_local)
            state_super = gru_super(state_super, merged_super)
            h, h_s = state_local, state_super

        g_nodes = PackedCommonReadout(self.out_dim, name="readout_0")(
            h, h0, node_mask
        )
        g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        g2 = jnp.concatenate([g, h_s], axis=-1)
        out = nn.relu(
            nn.Dense(self.out_dim, kernel_init=LecunNormal(),
                     name="linear_for_concat_super")(g2)
        )
        return out, {"atoms": h, "h0": h0, "super": h_s}


class PackedGWMPairPredictor(nn.Module):
    """Pair predictor over the packed layout for GGNN_GWM: one supergraph
    pass encodes both molecules of every pair (Siamese by construction),
    with the per-molecule supernode features as a (num_mols, F) table.
    Parameter-compatible with GWMPairPredictor(encoder=GGNN_GWM)."""

    encoder: nn.Module  # a PackedGGNN_GWM, name='encoder'
    head: nn.Module     # name='head'

    @nn.compact
    def __call__(self, atom_ids, adj, supers, mol_id, node_mask,
                 left_index, right_index, return_g: bool = False):
        num_mols = 2 * left_index.shape[0]
        g, _ = self.encoder(atom_ids, adj, supers, mol_id, node_mask, num_mols)
        g1 = jnp.take(g, left_index, axis=0)
        g2 = jnp.take(g, right_index, axis=0)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


class PackedGWMPairPredictorCOOCompact(nn.Module):
    """PackedGWMPairPredictor over the wire-compact COO layout: the
    adjacency ships as a bit-packed edge list and is scatter-built on
    device; the supernode table rides as one (num_mols, F) array
    (models/packed.compact_gwm_arrays).  Parameter tree identical to the
    dense-layout and padded GWM predictors."""

    encoder: nn.Module  # a PackedGGNN_GWM, name='encoder'
    head: nn.Module     # name='head'
    adj_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, nodes, e_packed, n_edges, supers,
                 left_index, right_index, return_g: bool = False):
        from gcnbmp_tpu.models.packed import decode_compact_wire
        from gcnbmp_tpu.ops.aggregate import adj_from_coo

        num_mols = 2 * left_index.shape[0]
        (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
         e_mask) = decode_compact_wire(nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        adj = adj_from_coo(
            e_tile, e_type, e_src, e_dst, e_mask, num_tiles=p, tile=t,
            dtype=self.adj_dtype,
        )
        g, _ = self.encoder(atom_ids, adj, supers, mol_id, node_mask, num_mols)
        g1 = jnp.take(g, left_index, axis=0)
        g2 = jnp.take(g, right_index, axis=0)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


class GWMPairPredictor(nn.Module):
    """Siamese GGNN_GWM pair predictor (6-ary input incl. supernodes;
    reference train_ggnn_hole_with_gwm.py:123-194).

    Signature matches PairPredictor with the supernode vectors as two
    trailing arguments, so the standard training/eval steps can thread
    them straight from the batch."""

    encoder: nn.Module
    head: nn.Module
    symmetric: Optional[str] = None

    @nn.compact
    def __call__(self, atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
                 super1=None, super2=None, deterministic=True,
                 return_aux=False):
        if super1 is None or super2 is None:
            raise ValueError(
                "GWMPairPredictor requires supernode features (build "
                "batches with make_batch(..., supernode_fn=...))"
            )
        g1, aux1 = self.encoder(atoms1, adj1, super1, mask1, deterministic)
        g2, aux2 = self.encoder(atoms2, adj2, super2, mask2, deterministic)
        logits = self.head(g1, g2)
        if self.symmetric == "or":
            logits = jnp.maximum(logits, self.head(g2, g1))
        elif self.symmetric == "and":
            logits = jnp.minimum(logits, self.head(g2, g1))
        if return_aux:
            return logits, {"g1": g1, "g2": g2, "aux1": aux1, "aux2": aux2}
        return logits


def default_supernode_fn(n_super_feature: int = DEFAULT_N_SUPER_FEATURE):
    """SMILES -> supernode feature vector (zeros for unparseable/fill
    rows); the standard supernode_fn for batchers and evaluators.
    Memoized by SMILES: a DDI dataset has ~500 unique drugs but ~100k
    pair rows, and per-epoch eval batching re-featurizes every row —
    the cache turns that into one featurization per drug."""
    import functools

    from gcnbmp_tpu.chem.smiles import mol_from_smiles

    @functools.lru_cache(maxsize=65536)
    def cached(smiles: str) -> np.ndarray:
        mol = mol_from_smiles(smiles) if smiles else None
        if mol is None:
            arr = np.zeros((n_super_feature,), np.float32)
        else:
            arr = supernode_features(mol, n_super_feature)
        arr.setflags(write=False)  # shared across callers — keep immutable
        return arr

    def fn(smiles: str) -> np.ndarray:
        return cached(smiles)

    return fn


def supernode_features(
    mol: Mol, n_super_feature: int = DEFAULT_N_SUPER_FEATURE
) -> np.ndarray:
    """sum/mean/max-pooled per-atom descriptors, zero-padded
    (reference add_super_nodes, data_generator.py:56-90, with the
    built-in 66-dim atom features standing in for deepchem Weave)."""
    feats = np.stack([drugfp_atom_features(mol, i) for i in range(mol.num_atoms)])
    vec = np.concatenate([feats.sum(0), feats.mean(0), feats.max(0)])
    if len(vec) < n_super_feature:
        vec = np.pad(vec, (0, n_super_feature - len(vec)))
    return vec[:n_super_feature].astype(np.float32)


def supernode_features_random(
    mol: Mol, n_super_feature: int = 244, seed: int = 0
) -> np.ndarray:
    """Mean of fixed random per-element embeddings (reference
    add_super_nodes2, data_generator.py:95-121)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(MAX_ATOMIC_NUM, n_super_feature)).astype(np.float32)
    rows = [w[a.atomic_num - 1] for a in mol.atoms]
    return np.mean(rows, axis=0).astype(np.float32)
