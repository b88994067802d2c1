"""Packed-supergraph GGNN forward — parameter-compatible with the padded
GGNN so trained weights swap freely between the two layouts.

Consumes PackedGraphBatch arrays (data/packing.py): tiles of 128 atoms
holding several molecules each.  Message passing runs per tile as
batched dense matmuls; the gated readout becomes a segment-sum over molecule ids.
Parameter tree matches models/ggnn.py exactly: embed, update_i/message/
dense, gru/{W,U,...}, readout_0/{i,j}.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.ggnn import GGNNMessage
from gcnbmp_tpu.models.layers import (
    ChainerGRUCell,
    EmbedAtomID,
    GraphLinear,
    MAX_ATOMIC_NUM,
)


class PackedGatedReadout(nn.Module):
    """Node-level gate * value; molecule sums happen outside via
    segment_sum.  Param names match GatedReadout (i, j)."""

    out_dim: int

    @nn.compact
    def __call__(self, h, h0, node_mask):
        gate = jax.nn.sigmoid(
            GraphLinear(self.out_dim, name="i")(jnp.concatenate([h, h0], axis=-1))
        )
        g = gate * GraphLinear(self.out_dim, name="j")(h)
        return g * node_mask[..., None]


class PackedCommonReadout(nn.Module):
    """Packed twin of CommonGGNNReadout (models/readouts.py; reference
    models/readout/ggnn_readout.py:13-59): per-node gate * value over
    [h, h0] (or h alone), masked.  The molecule sum happens outside via
    segment_sum; callers apply ``activation_agg`` after the sum, matching
    the padded readout's post-sum activation.  Param names (i, j) match
    CommonGGNNReadout so weights swap freely between layouts."""

    out_dim: int
    nobias: bool = False
    activation: Any = None

    @nn.compact
    def __call__(self, h, h0, node_mask):
        act = self.activation if self.activation is not None else (lambda x: x)
        h1 = jnp.concatenate([h, h0], axis=-1) if h0 is not None else h
        g1 = jax.nn.sigmoid(
            GraphLinear(self.out_dim, use_bias=not self.nobias, name="i")(h1)
        )
        g2 = act(GraphLinear(self.out_dim, use_bias=not self.nobias, name="j")(h1))
        return g1 * g2 * node_mask[..., None]


def _segment_mol_sum(g_nodes, mol_id, num_mols: int):
    """Sum per-node readout values into per-molecule embeddings.  Padding
    slots carry mol_id == num_mols and fall into the discarded segment.

    No ``indices_are_sorted`` hint: flattened mol_id is NOT globally
    sorted (each tile's trailing padding slots carry num_mols, then the
    next tile restarts lower), so the hint would be implementation-
    defined.

    ``GCNBMP_MOLSUM_DENSE=1`` swaps in the scatter-free dense form
    (_mol_sum_dense): the packed layout admits a gather-only equivalent
    of the segment_sum's scatter-add."""
    if MOL_SUM_DENSE:
        return _mol_sum_dense(g_nodes, mol_id, num_mols, _MOL_SUM_NMAX)
    flat = g_nodes.reshape(-1, g_nodes.shape[-1])
    ids = mol_id.reshape(-1)
    return jax.ops.segment_sum(
        flat, ids, num_segments=num_mols + 1
    )[:num_mols]


def _device_mol_runs(mol_id, num_mols: int):
    """Scatter-free per-molecule (start, count) over the flattened packed
    layout — searchsorted/gather only, no segment op, no sort.

    Exploits two invariants both packers construct (data/packing:
    molecule ids are remapped to (tile, offset) order and tile padding
    carries the num_mols sentinel):
      1. each tile's mol_id ROW is sorted ascending (real molecules in
         id order, then the sentinel), and
      2. tiles' first-slot ids are non-decreasing across tiles,
    so molecule m's tile is a binary search over column 0, and its
    offset/count a vmapped binary search within that one row.  Returns
    (starts (num_mols,) int32 flat positions, counts (num_mols,) int32);
    molecules absent from the batch get count 0."""
    p, t = mol_id.shape
    m = jnp.arange(num_mols, dtype=mol_id.dtype)
    first_col = mol_id[:, 0]
    b = jnp.clip(
        jnp.searchsorted(first_col, m, side="right").astype(jnp.int32) - 1,
        0, p - 1)
    rows = jnp.take(mol_id, b, axis=0)  # (num_mols, T)
    lo = jax.vmap(lambda r, q: jnp.searchsorted(r, q, side="left"))(rows, m)
    hi = jax.vmap(lambda r, q: jnp.searchsorted(r, q, side="right"))(rows, m)
    starts = b * t + lo.astype(jnp.int32)
    counts = (hi - lo).astype(jnp.int32)
    return starts, counts


def _mol_sum_dense(g_nodes, mol_id, num_mols: int, n_max: int):
    """_segment_mol_sum without the scatter: gather each molecule's rows
    into a (num_mols, n_max) dense table (slot indices from
    _device_mol_runs, backward a pure inverse gather via
    ops/slotgather.gather_slot_table) and sum the padded axis.  Same
    values as the segment form up to f32 summation order.  A molecule
    wider than n_max poisons the output NaN (same loud-failure contract
    as PackedSet2Set's dense mode)."""
    from gcnbmp_tpu.ops.slotgather import gather_slot_table, identity_mol_row

    flat = g_nodes.reshape(-1, g_nodes.shape[-1])
    ids = mol_id.reshape(-1)
    starts, counts = _device_mol_runs(mol_id, num_mols)
    j = jnp.arange(n_max, dtype=jnp.int32)[None, :]
    slots = jnp.clip(starts[:, None] + j, 0, flat.shape[0] - 1)
    amask = (j < counts[:, None]).astype(jnp.float32)
    table = gather_slot_table(flat, slots, amask, ids,
                              identity_mol_row(num_mols))
    out = jnp.sum(table, axis=1)
    return jnp.where(jnp.any(counts > n_max), jnp.nan, out)


# Scatter-free molecule readout sum (A/B knob; see _segment_mol_sum).
# Off by default until the hardware A/B lands; _MOL_SUM_NMAX must bound
# the largest molecule (loud NaN poisoning otherwise).
MOL_SUM_DENSE = os.environ.get("GCNBMP_MOLSUM_DENSE", "0") == "1"
_MOL_SUM_NMAX = int(os.environ.get("GCNBMP_MOLSUM_NMAX", "64"))


class PackedGGNN(nn.Module):
    """GGNN forward over packed tiles.

    __call__(atom_ids (P,T), adj (P,4,T,T), mol_id (P,T), node_mask (P,T),
             num_mols: static int) -> (g (num_mols, out_dim), aux)
    """

    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    n_atom_types: int = MAX_ATOMIC_NUM
    weight_tying: bool = True
    # jumping-knowledge fusion over per-layer states (JKNet;
    # ggnn_extras.LayerAggregator is per-node and layout-agnostic, so it
    # rides the packed tiles unchanged — padded slots are masked at the
    # readout).  Param names match the padded GGNN (layer_aggregator,
    # readout_agg) so weights swap between layouts.
    layer_aggregator: Any = None
    # jnp.bfloat16 -> message/GRU matmuls run in bf16 with f32
    # accumulation (params stay f32); None = full f32
    compute_dtype: Any = None

    @nn.compact
    def __call__(
        self,
        atom_ids: jnp.ndarray,
        adj: jnp.ndarray,
        mol_id: jnp.ndarray,
        node_mask: jnp.ndarray,
        num_mols: int,
    ) -> Tuple[jnp.ndarray, Dict[str, Any]]:
        h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atom_ids)
        h0 = h
        n_message = 1 if self.weight_tying else self.n_layers
        messages = [
            GGNNMessage(self.hidden_dim, dtype=self.compute_dtype,
                        name=f"update_{i}") for i in range(n_message)
        ]
        gru = ChainerGRUCell(self.hidden_dim, dtype=self.compute_dtype,
                             name="gru")
        gru_state = jnp.zeros_like(h)
        h_list = []
        for step in range(self.n_layers):
            m = messages[0 if self.weight_tying else step](h, adj)
            x = jnp.concatenate([h, m], axis=-1)
            gru_state = gru(gru_state, x)
            h = gru_state
            if self.layer_aggregator:
                h_list.append(h)
        if self.layer_aggregator:
            from gcnbmp_tpu.models.ggnn_extras import LayerAggregator

            h_agg, h0_agg = LayerAggregator(
                self.layer_aggregator, self.hidden_dim, self.n_layers,
                name="layer_aggregator",
            )(h_list, h0)
            g_nodes = PackedGatedReadout(self.out_dim, name="readout_agg")(
                h_agg, h0_agg, node_mask
            )
            g = _segment_mol_sum(g_nodes, mol_id, num_mols)
            return g, {"atoms": h, "h0": h0}
        g_nodes = PackedGatedReadout(self.out_dim, name="readout_0")(h, h0, node_mask)
        g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        return g, {"atoms": h, "h0": h0}


class PackedRelGCN(nn.Module):
    """RelGCN forward over packed tiles (reference models/relgcn.py:31-73).

    Reuses the padded RelGCNUpdate unchanged — its per-edge-type matmul
    is layout-agnostic over the leading (tile) axis, and tiles are
    block-diagonal per molecule so no messages cross molecules.  Param
    tree matches models/relgcn.RelGCN exactly (embed, conv_{i}/self+edge,
    readout/i+j) so trained weights swap freely between layouts."""

    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 2
    ch_list: Any = None
    n_atom_types: int = MAX_ATOMIC_NUM
    scale_adj: bool = False
    compute_dtype: Any = None

    @nn.compact
    def __call__(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        from gcnbmp_tpu.models.relgcn import RelGCNUpdate, rescale_adj

        chs = (list(self.ch_list) if self.ch_list
               else [self.hidden_dim] * (self.n_layers + 1))
        h = EmbedAtomID(self.n_atom_types, chs[0], name="embed")(atom_ids)
        if self.scale_adj:
            adj = rescale_adj(adj)
        for i in range(len(chs) - 1):
            h = jnp.tanh(RelGCNUpdate(chs[i + 1], dtype=self.compute_dtype,
                                      name=f"conv_{i}")(h, adj))
        g_nodes = PackedCommonReadout(
            self.out_dim, nobias=True, activation=jnp.tanh, name="readout"
        )(h, None, node_mask)
        g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        return g, {"atoms": h, "h0": None}


class PackedGIN(nn.Module):
    """GIN forward over packed tiles (reference models/gin.py:131-226).

    Reuses the padded GINUpdate unchanged (neighbor-sum + self + 2-layer
    MLP is layout-agnostic over the tile axis; padded slots never mix
    into real nodes because tile adjacency is block-diagonal, and the
    readout masks them).  Dropout runs deterministic on this path (the
    trainer rejects dropout>0 for packed compute paths).  Param tree
    matches models/gin.GIN (embed, update_{i}, readout_0/i+j)."""

    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    n_atom_types: int = MAX_ATOMIC_NUM
    dropout_ratio: float = 0.0
    weight_tying: bool = True
    compute_dtype: Any = None

    @nn.compact
    def __call__(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        from gcnbmp_tpu.models.gin import GINUpdate

        h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atom_ids)
        h0 = h
        n_message = 1 if self.weight_tying else self.n_layers
        updates = [
            GINUpdate(self.hidden_dim, self.dropout_ratio,
                      dtype=self.compute_dtype, name=f"update_{i}")
            for i in range(n_message)
        ]
        for step in range(self.n_layers):
            h = updates[0 if self.weight_tying else step](h, adj, True)
        g_nodes = PackedCommonReadout(self.out_dim, name="readout_0")(
            h, h0, node_mask
        )
        g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        return g, {"atoms": h, "h0": h0}


class PackedNFPReadout(nn.Module):
    """Packed twin of NFPReadout (models/readouts.py:96-107): per-node
    channel-softmax, masked; the molecule sum happens outside via
    segment_sum.  Param name (output_weight) matches NFPReadout."""

    out_dim: int

    @nn.compact
    def __call__(self, h, node_mask):
        i = GraphLinear(self.out_dim, name="output_weight")(h)
        i = jax.nn.softmax(i, axis=-1)
        return i * node_mask[..., None]


# Dense Set2Set (round 4): see PackedSet2Set.dense_n_max.  Default ON
# (A/B via GCNBMP_SET2SET_DENSE=0); parity + training tests cover both.
SET2SET_DENSE = os.environ.get("GCNBMP_SET2SET_DENSE", "1") == "1"

# Gather-only VJP for the slot-table atom gathers (round 4): the plain
# jnp.take backward is a (rows, ch) scatter-add; the packed layout's
# contiguous-run invariant makes the transpose a pure gather
# (ops/slotgather.py).  Bit-identical forward, exact backward;
# A/B via GCNBMP_GATHER_VJP=0.
GATHER_VJP = os.environ.get("GCNBMP_GATHER_VJP", "1") == "1"


def segment_softmax(scores, ids, valid, num_segments: int):
    """Numerically-stable softmax over segments: the packed twin of a
    per-molecule masked softmax.  scores (N, K), ids (N,), valid (N,);
    invalid rows get weight 0 and contribute nothing."""
    masked = jnp.where(valid[:, None] > 0, scores, -1e9)
    m = jax.ops.segment_max(masked, ids, num_segments=num_segments)
    e = jnp.exp(masked - m[ids]) * valid[:, None]
    s = jax.ops.segment_sum(e, ids, num_segments=num_segments)
    return e / jnp.maximum(s[ids], 1e-9)


class PackedSet2Set(nn.Module):
    """Set2Set over the packed layout (padded twin: readouts.Set2Set,
    reference models/readout/set2set.py:14-57): the per-molecule softmax
    attention becomes a segment-softmax over mol_id.  Param names (lstm)
    match Set2Set so weights swap freely between layouts."""

    channels: int
    processing_steps: int = 3
    # dense mode (round 4): the segment-op form runs per-step
    # q-gathers whose backwards are scatter-adds, plus 3 segment ops
    # per processing step.  Dense mode gathers each molecule's atoms
    # ONCE into a (num_mols, n_max, ch) table via an on-device
    # sort-built slot table, then every processing step is dense masked
    # softmax + two small einsums — zero segment ops in the loop.
    # Identical math; parity tested.  n_max must bound the largest
    # molecule (Trainer configs stay <= 64 atoms by construction).
    dense_n_max: int = 64

    @nn.compact
    def __call__(self, h, mol_id, node_mask, num_mols: int):
        ch = h.shape[-1]
        flat = h.reshape(-1, ch)
        ids = mol_id.reshape(-1)
        valid = node_mask.reshape(-1)
        cell = nn.OptimizedLSTMCell(self.channels, name="lstm")
        carry = cell.initialize_carry(jax.random.PRNGKey(0), (num_mols, 2 * ch))
        carry = jax.tree.map(jnp.zeros_like, carry)
        q_star = jnp.zeros((num_mols, 2 * ch), h.dtype)
        if SET2SET_DENSE:
            slots, amask, overflow = _device_slot_table(
                ids, valid, num_mols, self.dense_n_max)
            if GATHER_VJP:
                from gcnbmp_tpu.ops.slotgather import (
                    gather_slot_table, identity_mol_row)

                atoms = gather_slot_table(
                    flat, slots, amask, ids, identity_mol_row(num_mols))
            else:
                atoms = jnp.take(flat, slots.reshape(-1), axis=0).reshape(
                    num_mols, self.dense_n_max, ch) * amask[..., None]
            neg = jnp.asarray(-1e9, flat.dtype)
            for _ in range(self.processing_steps):
                carry, q = cell(carry, q_star)       # (M, ch)
                e = jnp.einsum("mnc,mc->mn", atoms, q)
                e = jnp.where(amask > 0, e, neg)
                a = jax.nn.softmax(e, axis=1) * amask
                r = jnp.einsum("mn,mnc->mc", a, atoms)
                q_star = jnp.concatenate([q, r], axis=-1)
            # a molecule larger than dense_n_max would be silently
            # truncated (the numpy twin molecule_slot_table RAISES);
            # inside jit the loudest available failure is poisoning the
            # output — the first loss/metric turns NaN instead of the
            # model silently training on clipped molecules (round-4
            # review finding).  The Trainer sizes dense_n_max from the
            # dataset, so this never fires in normal flows.
            q_star = jnp.where(overflow, jnp.nan, q_star)
            return q_star
        for _ in range(self.processing_steps):
            carry, q = cell(carry, q_star)  # (num_mols, ch)
            # energies: <h_n, q_{mol(n)}>; padding slots (ids == num_mols)
            # read the appended zero row and are masked anyway
            qx = jnp.concatenate([q, jnp.zeros((1, ch), q.dtype)], axis=0)
            e = jnp.sum(flat * qx[ids], axis=-1, keepdims=True)  # (N, 1)
            a = segment_softmax(e, ids, valid, num_mols + 1)
            r = jax.ops.segment_sum(
                a * flat, ids, num_segments=num_mols + 1
            )[:num_mols]
            q_star = jnp.concatenate([q, r], axis=-1)
        return q_star  # (num_mols, 2*ch)


def _device_slot_table(ids, valid, num_mols: int, n_max: int):
    """On-device molecule slot table: for each molecule, the flat node
    indices of its atoms — (num_mols, n_max) int32 + (num_mols, n_max)
    f32 mask — the jit twin of data/packing.molecule_slot_table.

    Exploits the packed-layout invariant that each molecule's atoms
    occupy a CONTIGUOUS flat index run (both packers bin whole
    molecules into tiles; tile padding follows the last molecule), so
    the table is start + arange — two segment ops, no sort.  Empty
    molecules (pair padding) get start = int-max, clipped, with an
    all-zero mask.  Also returns a scalar ``overflow`` flag (any
    molecule larger than n_max) for the caller to fail loudly on."""
    n = ids.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    starts = jax.ops.segment_min(
        pos, ids, num_segments=num_mols + 1)[:num_mols]
    counts = jax.ops.segment_sum(
        valid, ids, num_segments=num_mols + 1)[:num_mols]
    j = jnp.arange(n_max, dtype=jnp.int32)[None, :]
    slots = jnp.clip(starts[:, None] + j, 0, n - 1)
    amask = (j < counts[:, None]).astype(jnp.float32)
    overflow = jnp.any(counts > n_max)
    return slots, amask, overflow


class PackedMPNNReadout(nn.Module):
    """Packed twin of MPNNReadout (Set2Set x steps + 2-layer MLP;
    reference models/readout/mpnn_readout.py:38-66).  Returns
    per-MOLECULE vectors directly (Set2Set pools internally)."""

    out_dim: int
    hidden_dim: int
    processing_steps: int = 3
    s2s_n_max: int = 64  # dense-mode atom-table width (PackedSet2Set)

    @nn.compact
    def __call__(self, h, mol_id, node_mask, num_mols: int):
        from gcnbmp_tpu.models.layers import LecunNormal

        g = PackedSet2Set(self.hidden_dim, self.processing_steps,
                          dense_n_max=self.s2s_n_max,
                          name="set2set")(h, mol_id, node_mask, num_mols)
        g = nn.relu(nn.Dense(self.hidden_dim, kernel_init=LecunNormal(),
                             name="linear1")(g))
        return nn.Dense(self.out_dim, kernel_init=LecunNormal(),
                        name="linear2")(g)


# A/B switch for the sweep harness: False restores the round-2 einsum
# aggregation (8 small matmul passes/layer) for delta measurement.
EDGENET_FLAT = True
# Round 4 (VERDICT r3 #6): aggregate-first EdgeNet.  The r2/r3 forms
# materialize hm = (M_e - M0) h as a (P, 4, T, ch) HBM tensor every
# layer (plus adjacency transposes inside the layer), then contract
# with the adjacency.  Swapping the contraction order —
#   msgs[i, c] = sum_d (sum_{e,j} adj[e, i, j] h[j, d]) W[e*d + d', c]
# — aggregates h FIRST with the raw (P, 4T, T)-reshaped adjacency (a
# free reshape for the out direction; ONE hoisted transpose per
# forward, not per layer, for the in direction) and applies the
# per-edge-type matrices to the aggregate afterwards (4 small
# matmuls per direction).  No hm tensor, no per-layer adjacency
# transposes.  Off by default; A/B via GCNBMP_EDGENET_MODE=aggfirst.
EDGENET_AGGFIRST = (
    os.environ.get("GCNBMP_EDGENET_MODE", "dotgen") == "aggfirst"
)
# Round 5: contraction-side transposes.  The flat form materializes
# ``both`` (P, 2T, 4T) — TWICE the adjacency — solely so each layer is
# one matmul; but dot_general consumes either operand orientation, so
# both directed aggregations can be dot_generals straight on the
# raw (P, 4, T, T) adjacency (out: contract (e, j); in: contract
# (e, i)) with ZERO transposed copies and HALF the per-layer adjacency
# bytes.  The default (GCNBMP_EDGENET_MODE=flat restores the r4 form
# for A/Bs).
EDGENET_DOTGEN = (
    os.environ.get("GCNBMP_EDGENET_MODE", "dotgen") == "dotgen"
)
class PackedEdgeNet(nn.Module):
    """Packed twin of mpnn.EdgeNet: per-edge-type matrix messages plus
    the PER-MOLECULE non-edge background term M0 @ sum_{j in mol} h_j
    (a segment-sum + gather; equals the padded module's masked
    background).  Param names (nn1, nn2) match EdgeNet.

    ``adj_cat``: optional precomputed (P, 8T, T) stacked adjacency
    (build_edgenet_adj_cat) consumed by the aggregate-first form —
    hoisted out of the layer loop by PackedMPNN.

    ``compute_dtype=jnp.bfloat16`` runs the hm build and the adjacency
    contraction with bf16 operands (f32 accumulation) — the adjacency
    re-read is the layer's dominant HBM traffic and bf16 is exact for
    its 0/1 values."""

    out_channels: int
    edge_hidden_dim: int = 16
    compute_dtype: Any = None

    @nn.compact
    def __call__(self, h, adj, mol_id, node_mask, num_mols: int,
                 adj_cat=None, both=None):
        from gcnbmp_tpu.models.layers import LecunNormal

        p, t, ch = h.shape
        assert ch == self.out_channels, (ch, self.out_channels)
        basis = jnp.concatenate(
            [jnp.zeros((1, 4)), jnp.eye(4)], axis=0
        )
        z = nn.relu(nn.Dense(self.edge_hidden_dim, kernel_init=LecunNormal(),
                             name="nn1")(basis))
        mats = nn.Dense(ch * ch, kernel_init=LecunNormal(), name="nn2")(z)
        mats = mats.reshape(5, ch, ch)
        m0, m_types = mats[0], mats[1:]

        # per-molecule background: M0 @ segment-sum of real-node h
        flat = (h * node_mask[..., None]).reshape(-1, ch)
        ids = mol_id.reshape(-1)
        mol_sum = jax.ops.segment_sum(flat, ids, num_segments=num_mols + 1)
        bg = mol_sum @ m0.T  # (num_mols + 1, ch); row num_mols = pads
        bg_nodes = bg[mol_id]  # (P, T, ch)

        if EDGENET_AGGFIRST:
            if adj_cat is None:
                adj_cat = build_edgenet_adj_cat(adj)
            agg = jax.lax.dot_general(
                adj_cat.astype(h.dtype), h,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # (P, 8T, ch): rows [out e0..e3 | in e0..e3] x T
            w_e = jnp.transpose(m_types - m0, (0, 2, 1))  # (4, ch_in, ch_out)
            out = jnp.zeros((p, t, ch), jnp.float32)
            inn = jnp.zeros((p, t, ch), jnp.float32)
            for e in range(4):
                out = out + agg[:, e * t:(e + 1) * t] @ w_e[e]
                inn = inn + agg[:, (4 + e) * t:(5 + e) * t] @ w_e[e]
            return jnp.concatenate(
                [out + bg_nodes, inn + bg_nodes], axis=-1
            )

        cd = self.compute_dtype
        cast = (lambda x: x.astype(cd)) if cd is not None else (lambda x: x)
        hm = jnp.einsum(
            "tcd,pjd->ptjc", cast(m_types - m0), cast(h),
            preferred_element_type=jnp.float32,
        )  # (P, 4, T, ch)

        if EDGENET_DOTGEN:
            adjc = cast(adj) if both is None else both  # PackedMPNN
            # hoists the bf16 cast via the ``both`` slot (raw layout)
            out = jax.lax.dot_general(
                adjc, cast(hm),
                dimension_numbers=(((1, 3), (1, 2)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # (P, T_i, ch): sum_{e,j} adj[p,e,i,j] hm[p,e,j,c]
            inn = jax.lax.dot_general(
                adjc, cast(hm),
                dimension_numbers=(((1, 2), (1, 2)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # (P, T_j, ch): sum_{e,i} adj[p,e,i,j] hm[p,e,i,c]
            return jnp.concatenate(
                [out + bg_nodes, inn + bg_nodes], axis=-1
            )

        if not EDGENET_FLAT:  # round-2 form, kept for A/B sweeps
            def directed(a):
                return jnp.einsum("ptij,ptjc->pic", a, hm) + bg_nodes

            return jnp.concatenate(
                [directed(adj), directed(jnp.swapaxes(adj, 2, 3))], axis=-1
            )

        # AGG_FLAT-style single contraction (VERDICT r2 weak #5): both
        # directed aggregations — sum_{e,j} adj[p,e,i,j] * hm[p,e,j,c]
        # and its transpose — become ONE batched (2T, 4T) x (4T, ch)
        # matmul per layer by flattening (edge type, neighbor) into a
        # length-4T contraction and stacking the out-/in-direction rows,
        # instead of 8 separate (T, T) x (T, ch) passes.  ``both`` is
        # the step's dominant HBM tensor (P, 2T, 4T — 2x the adjacency)
        # and is hoisted out of the layer loop by PackedMPNN (built +
        # cast ONCE, re-read per layer).
        if both is None:
            both = build_edgenet_both(adj, cd)
        hm_flat = hm.reshape(p, 4 * t, ch)
        msgs = jax.lax.dot_general(
            both, cast(hm_flat),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # (P, 2T, ch)
        return jnp.concatenate(
            [msgs[:, :t] + bg_nodes, msgs[:, t:] + bg_nodes], axis=-1
        )


def build_edgenet_both(adj, compute_dtype=None):
    """The flat EdgeNet's (P, 2T, 4T) stacked out/in-direction
    adjacency, built (and cast — bf16 is exact for the 0/1 adjacency
    and halves its HBM re-read) ONCE per forward."""
    p, e, t, _ = adj.shape
    adj_out = jnp.transpose(adj, (0, 2, 1, 3)).reshape(p, t, e * t)
    adj_in = jnp.transpose(adj, (0, 3, 1, 2)).reshape(p, t, e * t)
    both = jnp.concatenate([adj_out, adj_in], axis=1)
    if compute_dtype is not None:
        both = both.astype(compute_dtype)
    return both


def build_edgenet_adj_cat(adj):
    """(P, 4, T, T) adjacency -> the (P, 8T, T) stacked layout consumed
    by the aggregate-first EdgeNet: rows 0..4T = out-direction (a free
    reshape — (e, i) are adjacent dims), rows 4T..8T = in-direction (the
    ONE transpose per forward, hoisted out of the layer loop)."""
    p, e, t, _ = adj.shape
    adj_out = adj.reshape(p, e * t, t)
    adj_in = jnp.swapaxes(adj, 2, 3).reshape(p, e * t, t)
    return jnp.concatenate([adj_out, adj_in], axis=1)


class PackedMPNN(nn.Module):
    """MPNN forward over packed tiles (reference models/mpnn.py:22-111):
    message in {edgenet, ggnn}, GRU update, readout in {set2set, ggnn}.
    Param tree matches models/mpnn.MPNN (embed, message_{i}, gru_{i},
    readout_0/...) so trained weights swap freely between layouts —
    padded-path evaluators work on packed-trained params."""

    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    n_atom_types: int = MAX_ATOMIC_NUM
    weight_tying: bool = True
    message_func: str = "edgenet"
    readout_func: str = "set2set"
    edge_hidden_dim: int = 16
    # bf16 message/GRU compute (f32 accumulation); the EdgeNet adjacency
    # contraction is the step's dominant HBM read and bf16 is exact for
    # the 0/1 adjacency (round 4, VERDICT r3 #7)
    compute_dtype: Any = None
    # dense-Set2Set atom-table width: must bound the largest molecule
    # (the Trainer passes the dataset's measured max, lane-rounded; 64
    # covers every drug in the synthetic sets)
    s2s_n_max: int = 64

    @nn.compact
    def __call__(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atom_ids)
        h0 = h
        n_message = 1 if self.weight_tying else self.n_layers
        if self.message_func == "edgenet":
            msgs = [
                PackedEdgeNet(self.hidden_dim, self.edge_hidden_dim,
                              compute_dtype=self.compute_dtype,
                              name=f"message_{i}")
                for i in range(n_message)
            ]
        else:
            msgs = [
                GGNNMessage(self.hidden_dim, dtype=self.compute_dtype,
                            name=f"message_{i}")
                for i in range(n_message)
            ]
        grus = [
            ChainerGRUCell(self.hidden_dim, dtype=self.compute_dtype,
                           name=f"gru_{i}")
            for i in range(n_message)
        ]
        gru_states = [jnp.zeros_like(h) for _ in range(n_message)]
        # EdgeNet adjacency layouts are loop-invariant — build ONCE per
        # forward: the aggregate-first (P, 8T, T) stack, or the flat
        # form's (P, 2T, 4T) ``both`` (the step's dominant HBM tensor;
        # cast bf16 here when compute_dtype asks — exact for 0/1 —
        # halving its per-layer re-read)
        adj_cat = (
            build_edgenet_adj_cat(adj)
            if self.message_func == "edgenet" and EDGENET_AGGFIRST else None
        )
        if self.message_func == "edgenet" and EDGENET_DOTGEN:
            # dotgen mode reuses the ``both`` slot for the hoisted
            # bf16 cast of the RAW adjacency (no stacked copy at all)
            both = (adj.astype(self.compute_dtype)
                    if self.compute_dtype is not None else adj)
        else:
            both = (
                build_edgenet_both(adj, self.compute_dtype)
                if self.message_func == "edgenet" and not EDGENET_AGGFIRST
                and EDGENET_FLAT else None
            )
        for step in range(self.n_layers):
            k = 0 if self.weight_tying else step
            if self.message_func == "edgenet":
                x = msgs[k](h, adj, mol_id, node_mask, num_mols,
                            adj_cat=adj_cat, both=both)
            else:
                m = msgs[k](h, adj)
                x = jnp.concatenate([h, m], axis=-1)
            gru_states[k] = grus[k](gru_states[k], x)
            h = gru_states[k]
        if self.readout_func == "ggnn":
            g_nodes = PackedCommonReadout(
                self.out_dim, name="readout_0"
            )(h, h0, node_mask)
            g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        else:
            g = PackedMPNNReadout(self.out_dim, self.hidden_dim,
                                  s2s_n_max=self.s2s_n_max,
                                  name="readout_0")(h, mol_id, node_mask,
                                                    num_mols)
        return g, {"atoms": h, "h0": h0}


class PackedNFP(nn.Module):
    """NFP forward over packed tiles (reference models/models/nfp.py:15-179).

    Reuses the padded NFPUpdate unchanged (degree-conditioned linears
    over a plain adjacency are layout-agnostic; tiles are
    block-diagonal, and self-connections are added for real slots only,
    exactly as the padded module does under a mask).  The per-layer
    readout accumulation becomes a per-layer segment-sum.  Param tree
    matches models/nfp.NFP (embed, update_{i}/linear_d*,
    readout_{i}/output_weight)."""

    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    max_degree: int = 6
    n_atom_types: int = MAX_ATOMIC_NUM

    @nn.compact
    def __call__(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        from gcnbmp_tpu.models.nfp import NFPUpdate

        h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atom_ids)
        plain = jnp.clip(jnp.sum(adj, axis=1), 0.0, 1.0)
        t = plain.shape[-1]
        eye = jnp.eye(t, dtype=plain.dtype)[None]
        plain = plain + eye * node_mask[:, :, None] * node_mask[:, None, :]
        deg = jnp.sum(plain, axis=1).astype(jnp.int32)
        g = 0.0
        for step in range(self.n_layers):
            h = NFPUpdate(self.hidden_dim, self.max_degree,
                          name=f"update_{step}")(h, plain, deg)
            per = PackedNFPReadout(self.out_dim, name=f"readout_{step}")(
                h, node_mask
            )
            g = g + _segment_mol_sum(per, mol_id, num_mols)
        return g, {"atoms": h, "h0": None}


class PackedPairPredictor(nn.Module):
    """Pair predictor over the packed layout; parameter-compatible with
    PairPredictor(encoder=GGNN, head=...) for the Siamese, no-coattention
    configuration (the flagship GGNN+HolE path)."""

    encoder: nn.Module  # a PackedGGNN, name='encoder'
    head: nn.Module     # name='head'

    @nn.compact
    def __call__(self, atom_ids, adj, mol_id, node_mask, left_index,
                 right_index, return_g: bool = False):
        num_mols = 2 * left_index.shape[0]
        g, _ = self.encoder(atom_ids, adj, mol_id, node_mask, num_mols)
        g1 = jnp.take(g, left_index, axis=0)
        g2 = jnp.take(g, right_index, axis=0)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


class PackedPairPredictorCOO(nn.Module):
    """PackedPairPredictor taking the adjacency as a padded COO edge list;
    the dense tile adjacency is built on device (ops/aggregate.adj_from_coo)
    so the host ships ~#edges ints instead of the P*4*T*T tensor.
    Parameter tree is identical to PackedPairPredictor (same encoder/head
    submodules) — weights swap freely between the two input layouts."""

    encoder: nn.Module  # a PackedGGNN, name='encoder'
    head: nn.Module     # name='head'
    adj_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, atom_ids, e_tile, e_type, e_src, e_dst, e_mask,
                 mol_id, node_mask, left_index, right_index,
                 return_g: bool = False):
        from gcnbmp_tpu.ops.aggregate import adj_from_coo

        p, t = atom_ids.shape
        adj = adj_from_coo(
            e_tile, e_type, e_src, e_dst, e_mask, num_tiles=p, tile=t,
            dtype=self.adj_dtype,
        )
        num_mols = 2 * left_index.shape[0]
        g, _ = self.encoder(atom_ids, adj, mol_id, node_mask, num_mols)
        g1 = jnp.take(g, left_index, axis=0)
        g2 = jnp.take(g, right_index, axis=0)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


def coo_batch_args(batch) -> Tuple:
    """The PackedCOOBatch fields in PackedPairPredictorCOO.__call__ order."""
    return (
        batch.atom_ids, batch.e_tile, batch.e_type, batch.e_src,
        batch.e_dst, batch.e_mask, batch.mol_id, batch.node_mask,
        batch.left_index, batch.right_index,
    )


def decode_compact_wire(nodes, e_packed, n_edges, num_mols: int):
    """Decode the wire-compact batch encoding (compact_coo_arrays) into
    (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst, e_mask).
    Single-sourced: the bit layout must match compact_coo_arrays.  Lane
    masks use (1 << sbits) - 1 — masking with (t - 1) is only correct
    for power-of-two tile sizes."""
    atom_ids, mol_id = nodes[0], nodes[1]
    t = atom_ids.shape[1]
    sbits = int(t - 1).bit_length()
    lane = (1 << sbits) - 1
    node_mask = (mol_id < num_mols).astype(jnp.float32)
    e_dst = e_packed & lane
    e_src = (e_packed >> sbits) & lane
    e_type = (e_packed >> (2 * sbits)) & 3
    e_tile = e_packed >> (2 * sbits + 2)
    e_mask = (
        jnp.arange(e_packed.shape[0], dtype=n_edges.dtype) < n_edges
    ).astype(jnp.float32)
    return atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst, e_mask


class PackedPairPredictorCOOCompact(nn.Module):
    """PackedPairPredictorCOO taking the wire-compact batch encoding
    (compact_coo_arrays): one (2, P, T) node array, one bit-packed int32
    edge array, and an edge count — ~2.5x fewer host->device bytes and 6
    instead of 11 transfers per batch.  Both masks are derived on device
    (padding slots carry mol_id == num_mols; padding edges are the tail
    beyond n_edges).  Parameter tree identical to the other packed
    predictors."""

    encoder: nn.Module  # a PackedGGNN, name='encoder'
    head: nn.Module     # name='head'
    adj_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, nodes, e_packed, n_edges, left_index, right_index,
                 return_g: bool = False):
        from gcnbmp_tpu.ops.aggregate import adj_from_coo

        num_mols = 2 * left_index.shape[0]
        (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
         e_mask) = decode_compact_wire(nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        adj = adj_from_coo(
            e_tile, e_type, e_src, e_dst, e_mask, num_tiles=p, tile=t,
            dtype=self.adj_dtype,
        )
        g, _ = self.encoder(atom_ids, adj, mol_id, node_mask, num_mols)
        g1 = jnp.take(g, left_index, axis=0)
        g2 = jnp.take(g, right_index, axis=0)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


class PackedCoattnPairPredictor(nn.Module):
    """Co-attention pair predictor over the wire-compact packed layout.

    Runs the Siamese packed GGNN, gathers each molecule's atom states
    out of the tile layout via a precomputed slot table
    (data/packing.molecule_slot_table), applies any of the 14
    co-attention modules (models/coattention.py) with proper masks, and
    scores with the head.  Field names match PairPredictor
    (encoder/coattention/head) so trained weights swap freely with the
    padded path (reference forward: train_binary.py:84-118)."""

    encoder: nn.Module       # a PackedGGNN, name='encoder'
    coattention: nn.Module   # name='coattention'
    head: nn.Module          # name='head'
    adj_dtype: Any = jnp.float32
    # None -> module global GATHER_VJP.  The Trainer pins False for
    # single-device scan mode, so the VJP form follows the execution
    # mode (an earlier tuning choice, not yet measured on the GPU).
    gather_vjp: Any = None

    @nn.compact
    def __call__(self, nodes, e_packed, n_edges, left_index, right_index,
                 left_slots, right_slots, left_mask, right_mask,
                 return_g: bool = False):
        from gcnbmp_tpu.ops.aggregate import adj_from_coo

        num_mols = 2 * left_index.shape[0]
        (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
         e_mask) = decode_compact_wire(nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        adj = adj_from_coo(
            e_tile, e_type, e_src, e_dst, e_mask, num_tiles=p, tile=t,
            dtype=self.adj_dtype,
        )
        g, aux = self.encoder(atom_ids, adj, mol_id, node_mask, num_mols)
        flat = aux["atoms"].reshape(p * t, -1)
        use_gather = (GATHER_VJP if self.gather_vjp is None
                      else self.gather_vjp)
        if use_gather:
            from gcnbmp_tpu.ops.slotgather import (
                gather_slot_table, side_mol_row)

            ids = mol_id.reshape(-1)
            atoms1 = gather_slot_table(
                flat, left_slots, left_mask, ids,
                side_mol_row(left_index, num_mols))
            atoms2 = gather_slot_table(
                flat, right_slots, right_mask, ids,
                side_mol_row(right_index, num_mols))
        else:
            atoms1 = jnp.take(flat, left_slots, axis=0) * left_mask[..., None]
            atoms2 = jnp.take(flat, right_slots, axis=0) * right_mask[..., None]
        g1 = jnp.take(g, left_index, axis=0)
        g2 = jnp.take(g, right_index, axis=0)
        g1, g2 = self.coattention(atoms1, g1, atoms2, g2, left_mask, right_mask)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


def compact_coattn_arrays(batch, n_max: int) -> Tuple:
    """compact_coo_arrays plus the per-pair atom slot tables consumed by
    PackedCoattnPairPredictor."""
    from gcnbmp_tpu.data.packing import molecule_slot_table

    from gcnbmp_tpu.data.packing import check_side_index_injective

    base = compact_coo_arrays(batch)
    slots, mask = molecule_slot_table(batch.mol_id, batch.num_mols, n_max)
    lmask = mask[batch.left_index]
    rmask = mask[batch.right_index]
    check_side_index_injective(batch.left_index, lmask)
    check_side_index_injective(batch.right_index, rmask)
    return base + (
        slots[batch.left_index], slots[batch.right_index],
        lmask, rmask,
    )


def compact_coo_arrays(batch) -> Tuple:
    """Encode a PackedCOOBatch into the wire-compact form consumed by
    PackedPairPredictorCOOCompact (numpy, ~1 ms/batch):

        nodes (2, P, T) int32, e_packed (E,) int32, n_edges () int32,
        left_index (B,), right_index (B,)

    Edge fields pack as tile | type | src | dst with src/dst in
    log2(T)-bit lanes (T=128 -> 7 bits; 4*P*T^2 must fit in int31,
    i.e. P < 2^15 tiles)."""
    import numpy as np

    t = batch.atom_ids.shape[1]
    sbits = int(t - 1).bit_length()
    nodes = np.stack([batch.atom_ids, batch.mol_id])
    # the wire form masks edges POSITIONALLY (arange < n_edges), so real
    # edges must be prefix-contiguous; pair-local merged batches
    # (pack_pair_dataset_coo_pairlocal) have per-device pad gaps —
    # stably compact them first (no-op for the standard packers)
    real = batch.e_mask > 0
    n_real = int(real.sum())
    e_tile, e_type, e_src, e_dst = (
        batch.e_tile, batch.e_type, batch.e_src, batch.e_dst)
    if not real[:n_real].all():
        order = np.argsort(~real, kind="stable")
        e_tile, e_type, e_src, e_dst = (
            e_tile[order], e_type[order], e_src[order], e_dst[order])
    e_packed = (
        ((e_tile << 2 | e_type) << (2 * sbits))
        | (e_src << sbits)
        | e_dst
    ).astype(np.int32)
    n_edges = np.int32(n_real)
    return nodes, e_packed, n_edges, batch.left_index, batch.right_index


def compact_gwm_arrays(batch) -> Tuple:
    """compact_coo_arrays + the per-molecule supernode table (set by
    data/packing.attach_supers_coo) — the wire tuple for
    PackedGWMPairPredictorCOOCompact."""
    nodes, e_packed, n_edges, left, right = compact_coo_arrays(batch)
    if batch.supers is None:
        raise ValueError("COO batch has no supernode features; build it "
                         "with attach_supers_coo")
    return nodes, e_packed, n_edges, batch.supers, left, right


PACKED_ENCODERS = ("ggnn", "relgcn", "gin", "nfp", "mpnn")


def make_packed_predictor(
    fp_hidden_dim: int = 32,
    fp_out_dim: int = 32,
    conv_layers: int = 8,
    weight_tying: bool = True,
    sim_method: str = "hole",
    class_num: int = 1,
    net_hidden_dims=(),
    coo: bool = False,
    compact: bool = False,
    attn: "str | None" = None,
    adj_dtype=jnp.float32,
    method: str = "ggnn",
    compute_dtype=None,
    layer_aggregator: "str | None" = None,
    s2s_n_max: int = 64,
    gather_vjp: Any = None,
) -> PackedPairPredictor:
    from gcnbmp_tpu.models.heads import HEADS

    head_kwargs: Dict[str, Any] = {"out_dim": class_num}
    if sim_method in ("hole", "mlp", "symmlp", "ntn", "dist-mult"):
        head_kwargs["hidden_dims"] = tuple(net_hidden_dims)
    if compute_dtype is not None and method not in ("ggnn", "relgcn", "gin",
                                                    "mpnn"):
        raise ValueError(
            "compute_dtype is plumbed for ggnn/relgcn/gin/mpnn encoders only")
    # checked before the ggnn-gwm early return so every non-ggnn method
    # rejects the flag instead of silently ignoring it (ADVICE r3 #2)
    if layer_aggregator is not None and method != "ggnn":
        raise ValueError("layer_aggregator rides the packed GGNN only")
    if method == "ggnn-gwm":
        # supernode features ride the batch as a (num_mols, F) table
        # (PackedGraphBatch/PackedCOOBatch .supers); dense and
        # wire-compact COO layouts
        if (coo and not compact) or attn is not None:
            raise ValueError(
                "ggnn-gwm rides the dense packed or wire-compact COO "
                "layouts, without co-attention"
            )
        from gcnbmp_tpu.models.gwm import (
            PackedGGNN_GWM,
            PackedGWMPairPredictor,
            PackedGWMPairPredictorCOOCompact,
        )

        head = HEADS[sim_method](name="head", **head_kwargs)
        encoder = PackedGGNN_GWM(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
            hidden_dim_super=fp_hidden_dim, n_layers=conv_layers,
            weight_tying=weight_tying, name="encoder",
        )
        if compact:
            return PackedGWMPairPredictorCOOCompact(
                encoder=encoder, head=head, adj_dtype=adj_dtype
            )
        return PackedGWMPairPredictor(encoder=encoder, head=head)
    if method == "ggnn":
        encoder = PackedGGNN(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim, n_layers=conv_layers,
            weight_tying=weight_tying, compute_dtype=compute_dtype,
            layer_aggregator=layer_aggregator,
            name="encoder",
        )
    elif method == "relgcn":
        encoder = PackedRelGCN(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim, n_layers=conv_layers,
            compute_dtype=compute_dtype, name="encoder",
        )
    elif method == "gin":
        encoder = PackedGIN(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim, n_layers=conv_layers,
            weight_tying=weight_tying, compute_dtype=compute_dtype,
            name="encoder",
        )
    elif method == "nfp":
        encoder = PackedNFP(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim, n_layers=conv_layers,
            name="encoder",
        )
    elif method == "mpnn":
        encoder = PackedMPNN(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim, n_layers=conv_layers,
            weight_tying=weight_tying, compute_dtype=compute_dtype,
            s2s_n_max=s2s_n_max, name="encoder",
        )
    else:
        raise ValueError(
            f"packed compute paths support methods {PACKED_ENCODERS}, "
            f"got {method!r}"
        )
    head = HEADS[sim_method](name="head", **head_kwargs)
    if attn is not None:
        from gcnbmp_tpu.models.coattention import build_coattention

        return PackedCoattnPairPredictor(
            encoder=encoder,
            coattention=build_coattention(
                attn, hidden_dim=fp_hidden_dim, out_dim=fp_out_dim
            ),
            head=head,
            adj_dtype=adj_dtype,
            gather_vjp=gather_vjp,
        )
    if compact:
        return PackedPairPredictorCOOCompact(
            encoder=encoder, head=head, adj_dtype=adj_dtype
        )
    if coo:
        return PackedPairPredictorCOO(
            encoder=encoder, head=head, adj_dtype=adj_dtype
        )
    return PackedPairPredictor(encoder=encoder, head=head)
