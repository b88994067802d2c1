"""GGNN optional machinery: masked self-attention, layer aggregators,
EdgeNetwork message function, Set2Vec readout, BiRNN helpers.

Reference: models/ggnn.py — masked_self_attention (:376-405),
layer_aggregation (:407-579), EdgeNetwork (:657-720), Set2Vec (:723-822),
LSTMWithoutInput (:825-849), FeedForward (:852-885).

Quirk triage (documented deviations, SURVEY §7.5):
- The reference Set2Vec creates its attention weights as plain chainer
  Variables INSIDE forward — freshly re-sampled (w1, w2) / zero (v)
  constants every call, never trained (ggnn.py:748-753, 784-790).  Here
  they are ordinary trainable parameters.
- LSTMWithoutInput's cell candidate passes through sigmoid AND tanh
  (c = f*c_prev + i*tanh(sigmoid(Wc m)), ggnn.py:841-843) — replicated
  exactly.
- layer_aggregator='self-attn' is unfinished in the reference
  (falls through returning None, ggnn.py:573-579) and raises here.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import LecunNormal

NEG_BIG = -9e15


class MaskedSelfAttention(nn.Module):
    """GAT-style masked self-attention over atoms
    (reference masked_self_attention, ggnn.py:376-405): h -> W h;
    e_ij = leaky_relu(a([Wh_i ‖ Wh_j])); masked softmax over neighbors
    (adjacency summed over edge types); h' = elu(attention @ Wh)."""

    hidden_dim: int

    @nn.compact
    def __call__(self, h: jnp.ndarray, adj: jnp.ndarray) -> jnp.ndarray:
        a = jnp.sum(adj, axis=1)  # (B, N, N)
        wh = nn.Dense(self.hidden_dim, use_bias=False,
                      kernel_init=LecunNormal(), name="linear_transform")(h)
        att_vec = nn.Dense(1, use_bias=False, kernel_init=LecunNormal(),
                           name="neural_network")
        n = h.shape[1]
        pair = jnp.concatenate(
            [
                jnp.broadcast_to(wh[:, :, None, :], (*wh.shape[:2], n, wh.shape[-1])),
                jnp.broadcast_to(wh[:, None, :, :], (wh.shape[0], n, n, wh.shape[-1])),
            ],
            axis=-1,
        )
        e = nn.leaky_relu(att_vec(pair)[..., 0])  # (B, N, N)
        e = jnp.where(a > 0, e, NEG_BIG)
        attention = jax.nn.softmax(e, axis=2)
        return nn.elu(jnp.einsum("bij,bjc->bic", attention, wh))


class GGNNEdgeNetwork(nn.Module):
    """'edge_network' message function (reference EdgeNetwork,
    ggnn.py:657-720): per-pair edge one-hot -> MLP -> node_dim^2 matrix;
    message_i = sum_j M(e_ij) h_j.  Factored into the 5 possible edge
    vectors like models/mpnn.py's EdgeNet (same math, O(1) MLP evals)."""

    node_dim: int
    edge_hidden_dim: int = 16
    n_hidden_layers: int = 0
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, h: jnp.ndarray, adj: jnp.ndarray) -> jnp.ndarray:
        num_edge_type = adj.shape[1]
        basis = jnp.concatenate(
            [jnp.zeros((1, num_edge_type)), jnp.eye(num_edge_type)], axis=0
        )
        z = basis
        for i in range(self.n_hidden_layers):
            z = self.activation(
                nn.Dense(self.edge_hidden_dim, kernel_init=LecunNormal(),
                         name=f"hidden_{i}")(z)
            )
        mats = nn.Dense(self.node_dim ** 2, kernel_init=LecunNormal(),
                        name="output")(z).reshape(-1, self.node_dim, self.node_dim)
        m0, m_types = mats[0], mats[1:]
        hm = jnp.einsum("tcd,bjd->btjc", m_types - m0, h)
        h_m0 = jnp.einsum("cd,bjd->bc", m0, h)
        msg = jnp.einsum("btij,btjc->bic", adj, hm) + h_m0[:, None, :]
        return msg


class LSTMWithoutInput(nn.Module):
    """Input-less LSTM block (reference ggnn.py:825-849, including the
    sigmoid-then-tanh cell-candidate quirk)."""

    node_dim: int

    @nn.compact
    def __call__(self, mprev: jnp.ndarray, cprev: jnp.ndarray):
        dense = lambda name: nn.Dense(
            self.node_dim, kernel_init=LecunNormal(), name=name
        )
        i_g = jax.nn.sigmoid(dense("input_gate")(mprev))
        f_g = jax.nn.sigmoid(dense("forget_gate")(mprev))
        cprime = jax.nn.sigmoid(dense("cell_gate")(mprev))
        c = f_g * cprev + i_g * jnp.tanh(cprime)
        o_g = jax.nn.sigmoid(dense("output_gate")(mprev))
        return o_g * jnp.tanh(c), c


class Set2Vec(nn.Module):
    """set2vec readout (reference ggnn.py:723-822): linear node embed,
    LSTMWithoutInput attention loop, feed-forward output."""

    node_dim: int
    output_dim: int
    num_timesteps: int = 3
    num_output_hidden_layers: int = 0
    output_hidden_dim: int = 16
    activation: Callable = nn.relu

    @nn.compact
    def __call__(
        self, h: jnp.ndarray, mask: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        b, n, d = h.shape
        assert d == self.node_dim, (d, self.node_dim)
        w1 = self.param("attention_w1", nn.initializers.glorot_uniform(), (d, d))
        w2 = self.param("attention_w2", nn.initializers.glorot_uniform(), (d, d))
        v = self.param("attention_v", nn.initializers.glorot_uniform(), (d, 1))
        embedded = h @ w1  # (B, N, D)
        lstm = LSTMWithoutInput(d, name="lstm_block")
        mprev = jnp.zeros((b, 2 * d), h.dtype)
        cprev = jnp.zeros((b, d), h.dtype)
        m = mprev
        for _ in range(self.num_timesteps):
            m_out, cprev = lstm(mprev, cprev)
            query = (m_out @ w2)[:, None, :]  # (B, 1, D)
            energies = (jnp.tanh(query + embedded) @ v)[..., 0]  # (B, N)
            if mask is not None:
                energies = jnp.where(mask > 0, energies, NEG_BIG)
            att = jax.nn.softmax(energies, axis=1)
            if mask is not None:
                att = att * mask
            read = jnp.sum(att[..., None] * embedded, axis=1)  # (B, D)
            m = jnp.concatenate([m_out, read], axis=1)  # (B, 2D)
            mprev = m
        out = m
        for i in range(self.num_output_hidden_layers):
            out = self.activation(
                nn.Dense(self.output_hidden_dim, kernel_init=LecunNormal(),
                         name=f"ff_hidden_{i}")(out)
            )
        return nn.Dense(self.output_dim, kernel_init=LecunNormal(),
                        name="ff_output")(out)


def _bi_rnn(cell_fwd, cell_bwd, seq: List[jnp.ndarray], carry_init):
    """Run a pair of RNN cells forward/backward over a short list of
    (B*, D) steps; returns list of (B*, 2D) outputs."""
    outs_f, outs_b = [], []
    carry = carry_init()
    for x in seq:
        carry, y = cell_fwd(carry, x)
        outs_f.append(y)
    carry = carry_init()
    for x in reversed(seq):
        carry, y = cell_bwd(carry, x)
        outs_b.append(y)
    outs_b = list(reversed(outs_b))
    return [jnp.concatenate([f, bkwd], axis=-1) for f, bkwd in zip(outs_f, outs_b)]


class LayerAggregator(nn.Module):
    """Jumping-knowledge-style aggregation of per-layer hidden states
    (reference layer_aggregation, ggnn.py:407-579).  Returns the
    aggregated per-atom matrix + the matching h0 to feed the readout."""

    mode: str
    hidden_dim: int
    n_layers: int

    @nn.compact
    def __call__(self, h_list: List[jnp.ndarray], h0: jnp.ndarray):
        mode = self.mode
        if mode == "concat":
            h = jnp.concatenate(h_list, axis=-1)
            return h, jnp.concatenate([h0] * self.n_layers, axis=-1)
        if mode == "max-pool":
            return jnp.max(jnp.stack(h_list, axis=-2), axis=-2), h0
        if mode == "avg":
            # JKNet AvgAggregator (reference models/ggnn_dev_jknet.py:215)
            return jnp.mean(jnp.stack(h_list, axis=-2), axis=-2), h0
        if mode in ("lstm", "gru", "lstm-attn", "gru-attn"):
            b, n, d = h_list[0].shape
            seq = [h.reshape(b * n, d) for h in h_list]
            if mode.startswith("lstm"):
                cf = nn.OptimizedLSTMCell(d, name="rnn_fwd")
                cb = nn.OptimizedLSTMCell(d, name="rnn_bwd")
                init = lambda: jax.tree.map(
                    jnp.zeros_like,
                    cf.initialize_carry(jax.random.PRNGKey(0), (b * n, d)),
                )
            else:
                cf = nn.GRUCell(d, name="rnn_fwd")
                cb = nn.GRUCell(d, name="rnn_bwd")
                init = lambda: jax.tree.map(
                    jnp.zeros_like,
                    cf.initialize_carry(jax.random.PRNGKey(0), (b * n, d)),
                )
            outs = _bi_rnn(cf, cb, seq, init)  # L x (B*N, 2D)
            if mode in ("lstm", "gru"):
                # [forward of last step ‖ backward of first step]
                agg = jnp.concatenate([outs[-1][:, :d], outs[0][:, d:]], axis=-1)
            else:
                # per-channel softmax attention over layers
                stacked = jnp.stack(outs, axis=1)  # (B*N, L, 2D)
                a = jnp.swapaxes(stacked, 1, 2).reshape(-1, self.n_layers)
                attn = nn.Dense(self.n_layers, kernel_init=LecunNormal(),
                                name="attn_dense")(a)
                attn = jax.nn.softmax(attn, axis=1)
                attn = attn.reshape(b * n, 2 * d, self.n_layers)
                attn = jnp.swapaxes(attn, 1, 2)  # (B*N, L, 2D)
                agg = jnp.sum(stacked * attn, axis=1)
            h = agg.reshape(b, n, 2 * d)
            return h, jnp.concatenate([h0, h0], axis=-1)
        if mode == "attn":
            stacked = jnp.stack(h_list, axis=-2)  # (B, N, L, D)
            b, n, L, d = stacked.shape
            a = jnp.swapaxes(stacked, -1, -2).reshape(-1, L)
            attn = nn.Dense(L, kernel_init=LecunNormal(), name="attn_dense")(a)
            attn = jax.nn.softmax(attn, axis=1)
            attn = attn.reshape(b, n, d, L)
            attn = jnp.swapaxes(attn, -1, -2)  # (B, N, L, D)
            return jnp.sum(stacked * attn, axis=-2), h0
        raise NotImplementedError(
            f"layer_aggregator={mode!r} (the reference's 'self-attn' branch "
            "is unfinished, ggnn.py:573-579)"
        )
