"""GGNN encoder — the paper's flagship molecule encoder.

Functional JAX re-design of the reference GGNN (models/ggnn.py:19-654):
EmbedAtomID -> T steps of [per-edge-type linear message -> adjacency
aggregation -> Chainer-GRU update] -> gated readout
``sigmoid(i([h, h0])) * j(h)`` summed over atoms.

Differences from the reference, by design:
- stateless: per-atom hidden states / per-layer readouts are returned in
  an aux dict instead of being cached on the module
  (reference ggnn_att.py:662-665 ``get_atom_array``);
- an explicit ``mask`` input controls whether padded atoms participate in
  the readout.  The reference lets padded atoms contribute embed(0)-drived
  values to the readout sum (no is_real_node masking in models/ggnn.py's
  readout); pass ``mask=None`` to reproduce that for parity runs, or the
  batch's node mask for the corrected behavior (default in configs).
- supports both atom-ID int inputs and dense per-atom feature matrices
  (reference models/ggnn.py:598-603 dtype dispatch).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import (
    ChainerGRUCell,
    EmbedAtomID,
    GraphLinear,
    MAX_ATOMIC_NUM,
)
from gcnbmp_tpu.ops.aggregate import edge_type_aggregate

NUM_EDGE_TYPE = 4


class GatedReadout(nn.Module):
    """g = sum_atoms sigmoid(i([h, h0])) * j(h)
    (reference: models/ggnn.py:333-341)."""

    out_dim: int

    @nn.compact
    def __call__(
        self,
        h: jnp.ndarray,
        h0: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        gate = jax.nn.sigmoid(
            GraphLinear(self.out_dim, name="i")(jnp.concatenate([h, h0], axis=-1))
        )
        g = gate * GraphLinear(self.out_dim, name="j")(h)
        if mask is not None:
            g = g * mask[..., None]
        return jnp.sum(g, axis=-2)  # sum over atom axis: (B, N, D) -> (B, D)


class GGNNMessage(nn.Module):
    """Edge-type-conditioned message computation + aggregation
    (reference: models/ggnn.py:222-242, 'matrix_multiply' message fn).

    ``dtype``: computation dtype for the message matmul and aggregation
    operands (params stay f32; the aggregation accumulates in f32 via
    preferred_element_type) — jnp.bfloat16 = mixed-precision path."""

    hidden_dim: int
    dtype: Any = None

    @nn.compact
    def __call__(self, h: jnp.ndarray, adj: jnp.ndarray) -> jnp.ndarray:
        b, n, ch = h.shape
        # GraphLinear h -> 4h; reference reshapes to (mb, atom, ch, edge)
        # i.e. edge type is the FASTEST axis of the 4h output — kept
        # identical so weights are layout-compatible with a transcription.
        m = GraphLinear(NUM_EDGE_TYPE * self.hidden_dim, dtype=self.dtype,
                        name="message")(h)
        m = m.reshape(b, n, self.hidden_dim, NUM_EDGE_TYPE)
        m = jnp.transpose(m, (0, 3, 1, 2))  # (B, E, N, H)
        if self.dtype is not None:
            # adjacency entries are small integers (0/1 bond counts) —
            # exact in bf16; keeps both aggregation operands low-precision
            adj = adj.astype(self.dtype)
        return edge_type_aggregate(adj, m)  # (B, N, H)


class GGNNUpdate(nn.Module):
    """One message-passing step: messages + shared-GRU update.  Kept for
    standalone use (SURVEY §2.2 reusable blocks); note the full GGNN
    shares ONE GRU across all layers (see GGNN below)."""

    hidden_dim: int

    @nn.compact
    def __call__(self, h: jnp.ndarray, adj: jnp.ndarray) -> jnp.ndarray:
        m = GGNNMessage(self.hidden_dim, name="msg")(h, adj)
        x = jnp.concatenate([h, m], axis=-1)
        return ChainerGRUCell(self.hidden_dim, name="gru")(h, x)


class GGNN(nn.Module):
    """Gated Graph Neural Network encoder.

    Args mirror the reference constructor (models/ggnn.py:39-166); options
    not yet implemented raise at call time so configs stay honest.
    """

    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    n_atom_types: int = MAX_ATOMIC_NUM
    concat_hidden: bool = False
    weight_tying: bool = True
    dropout_rate: float = 0.0
    batch_normalization: bool = False
    layer_aggregator: Optional[str] = None
    use_attention: bool = False          # masked self-attention after update
    update_attention: bool = False       # see NotImplemented note below
    attention_tying: bool = True
    message_function: str = "matrix_multiply"  # or 'edge_network'
    edge_hidden_dim: int = 16
    readout_function: str = "graph_level"      # or 'set2vec'
    num_timesteps: int = 3
    num_output_hidden_layers: int = 0
    output_hidden_dim: int = 16
    context: bool = False                # BiLSTM context embedding over atoms

    @nn.compact
    def __call__(
        self,
        atoms: jnp.ndarray,
        adj: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, Dict[str, Any]]:
        """Returns (g [B, out_dim or n_layers*out_dim], aux dict)."""
        if jnp.issubdtype(atoms.dtype, jnp.integer):
            h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atoms)
        else:
            # pre-embedded float inputs (reference dtype dispatch,
            # models/ggnn.py:598-603); also the saliency entry point —
            # eval/saliency.py differentiates w.r.t. these embeddings
            h = atoms
        if self.context:
            # BiLSTM context embedding over the atom sequence
            # (reference models/ggnn.py:607-611, NStepBiLSTM with
            # out_size hidden_dim/2 per direction)
            half = self.hidden_dim // 2
            fwd = nn.RNN(nn.OptimizedLSTMCell(half), name="context_fwd")
            bwd = nn.RNN(nn.OptimizedLSTMCell(half), reverse=True,
                         keep_order=True, name="context_bwd")
            h = jnp.concatenate([fwd(h), bwd(h)], axis=-1)
        h0 = h

        if self.update_attention:
            raise NotImplementedError(
                "the reference's update_with_attention has an internal shape "
                "mismatch and cannot execute (models/ggnn.py:265-331: "
                "Linear(hidden->hidden) output reshaped to 2*hidden); "
                "use use_attention (masked self-attention) instead"
            )

        # Per-layer message linears when untied, but ONE GRU shared across
        # all layers — the reference constructs a single
        # ``self.update_layer = links.GRU`` regardless of weight_tying
        # (models/ggnn.py:132) whose state chains across layers.
        n_message = 1 if self.weight_tying else self.n_layers
        if self.message_function == "matrix_multiply":
            messages = [
                GGNNMessage(self.hidden_dim, name=f"update_{i}")
                for i in range(n_message)
            ]
        elif self.message_function == "edge_network":
            from gcnbmp_tpu.models.ggnn_extras import GGNNEdgeNetwork

            messages = [
                GGNNEdgeNetwork(self.hidden_dim, self.edge_hidden_dim,
                                name=f"update_{i}")
                for i in range(n_message)
            ]
        else:
            raise ValueError(
                f"no such message function {self.message_function!r}"
            )
        gru = ChainerGRUCell(self.hidden_dim, name="gru")
        n_attention = 1 if self.attention_tying else self.n_layers
        if self.use_attention:
            from gcnbmp_tpu.models.ggnn_extras import MaskedSelfAttention

            attentions = [
                MaskedSelfAttention(self.hidden_dim, name=f"attention_{i}")
                for i in range(n_attention)
            ]
        n_readout = self.n_layers if self.concat_hidden else 1
        if self.readout_function == "set2vec":
            from gcnbmp_tpu.models.ggnn_extras import Set2Vec

            readouts = [
                Set2Vec(
                    node_dim=2 * self.hidden_dim, output_dim=self.out_dim,
                    num_timesteps=self.num_timesteps,
                    num_output_hidden_layers=self.num_output_hidden_layers,
                    output_hidden_dim=self.output_hidden_dim,
                    name=f"readout_{i}",
                )
                for i in range(n_readout)
            ]

            def do_readout(idx, h_, h0_, mask_):
                return readouts[idx](jnp.concatenate([h_, h0_], axis=-1), mask_)

        else:
            readouts = [
                GatedReadout(self.out_dim, name=f"readout_{i}")
                for i in range(n_readout)
            ]

            def do_readout(idx, h_, h0_, mask_):
                return readouts[idx](h_, h0_, mask_)

        g_list = []
        h_list = []
        gru_state = jnp.zeros_like(h)  # reset_state() (reference :601)
        for step in range(self.n_layers):
            msg = messages[0 if self.weight_tying else step]
            m = msg(h, adj)
            x = jnp.concatenate([h, m], axis=-1)
            gru_state = gru(gru_state, x)
            h = gru_state
            if self.use_attention:
                # masked self-attention transforms h but NOT the GRU's
                # recurrent state (reference __call__ :616-623)
                h = attentions[0 if self.attention_tying else step](h, adj)
            if self.batch_normalization:
                h = nn.BatchNorm(
                    use_running_average=deterministic, name=f"bn_{step}"
                )(h)
            if self.dropout_rate > 0.0:
                h = nn.Dropout(rate=self.dropout_rate, deterministic=deterministic)(h)
            if self.concat_hidden:
                g_list.append(do_readout(step, h, h0, mask))
            if self.layer_aggregator:
                h_list.append(h)

        aux: Dict[str, Any] = {"atoms": h, "h0": h0, "h_list": h_list, "g_list": g_list}

        if self.layer_aggregator:
            from gcnbmp_tpu.models.ggnn_extras import LayerAggregator

            h_agg, h0_agg = LayerAggregator(
                self.layer_aggregator, self.hidden_dim, self.n_layers,
                name="layer_aggregator",
            )(h_list, h0)
            # the reference rebuilds i/j layers sized for the aggregated
            # input (models/ggnn.py:240-257); Dense infers input width.
            g = GatedReadout(self.out_dim, name="readout_agg")(h_agg, h0_agg, mask)
            return g, aux

        if self.concat_hidden:
            return jnp.concatenate(g_list, axis=-1), aux
        g = do_readout(0, h, h0, mask)
        return g, aux
