"""Building-block layers with Chainer-matching semantics.

These pin the exact math of the reference's external dependencies
(SURVEY §2.8): chainer_chemistry.links.GraphLinear / EmbedAtomID and
chainer.links.GRU (StatefulGRU), so that activation-level parity tests can
transcribe the reference equations directly.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

# chainer_chemistry.config.MAX_ATOMIC_NUM — EmbedAtomID vocab size
# (reference: models/ggnn.py:14,87).
MAX_ATOMIC_NUM = 117

# Lookup strategy for EmbedAtomID: one-hot matmul (a matmul both ways)
# vs gather (whose backward is a scatter-add into the 117-row table).
# Numerically exact either way (a one-hot row select); the one-hot form
# is the default from earlier tuning, not yet measured on the GPU; set
# GCNBMP_ONEHOT_EMBED=0 to A/B the gather.
import os as _os

ONEHOT_EMBED = _os.environ.get("GCNBMP_ONEHOT_EMBED", "1") == "1"

LecunNormal = nn.initializers.lecun_normal


class GraphLinear(nn.Module):
    """Linear over the last axis of (..., ch) — chainer_chemistry's
    GraphLinear (used throughout reference models/ggnn.py).

    ``dtype`` is the computation dtype (params stay f32); set to
    jnp.bfloat16 for mixed-precision compute."""

    features: int
    use_bias: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return nn.Dense(
            self.features,
            use_bias=self.use_bias,
            kernel_init=LecunNormal(),
            dtype=self.dtype,
            name="dense",
        )(x)


class EmbedAtomID(nn.Module):
    """Atom-ID embedding (chainer_chemistry EmbedAtomID; chainer EmbedID
    initializes W ~ Normal(1.0))."""

    num_embeddings: int = MAX_ATOMIC_NUM
    features: int = 16

    @nn.compact
    def __call__(self, ids: jnp.ndarray) -> jnp.ndarray:
        emb = self.param(
            "embedding",
            nn.initializers.normal(stddev=1.0),
            (self.num_embeddings, self.features),
        )
        if ONEHOT_EMBED:
            # one-hot matmul instead of gather: the table is tiny (117
            # rows) so the lookup is a (rows, V) x (V, H) matmul, and
            # the BACKWARD becomes onehot^T @ dh (a matmul) instead of a
            # scatter-add into the table.
            # precision=HIGHEST: a reduced-precision default (bf16 or
            # TF32 operand passes) would round the table values; full
            # f32 keeps the lookup exact and the matmul is tiny.
            # clamp ids like jnp.take does, so both paths share the same
            # out-of-range semantics (one_hot alone would yield all-zero
            # rows where take clamps to the last table row) and the flag
            # stays a pure perf A/B (ADVICE r3 #4)
            ids = jnp.clip(ids, 0, self.num_embeddings - 1)
            oh = jax.nn.one_hot(ids, self.num_embeddings, dtype=emb.dtype)
            return jnp.matmul(oh, emb, precision=jax.lax.Precision.HIGHEST)
        return jnp.take(emb, ids, axis=0)


class ChainerGRUCell(nn.Module):
    """chainer.links.GRU (StatefulGRU) cell.

    Semantics (chainer/links/connection/gru.py, used as the GGNN update
    layer at reference models/ggnn.py:132,260):

        z  = sigmoid(W_z x + U_z h)
        r  = sigmoid(W_r x + U_r h)
        h~ = tanh(W x + U (r * h))
        h' = z * h~ + (1 - z) * h

    With ``h = 0`` (the reset_state() start of every molecule forward,
    reference models/ggnn.py:601) this reduces exactly to Chainer's
    None-state branch ``h' = z * h~`` — so a zero-initialized state
    reproduces the reference layer-0 behavior bit-for-bit.
    """

    features: int
    # Optionally merge the three x-side matmuls into one (.., 2H) x
    # (2H, 3H) pass and the two h-side gate matmuls into (.., H) x
    # (H, 2H): identical math and identical parameter tree (kernels
    # concatenated at apply time).  Off by default (the unmerged form
    # scheduled better in earlier tuning; not yet measured on the GPU).
    merge_matmuls: bool = False
    # computation dtype (params stay f32); jnp.bfloat16 for
    # mixed-precision compute
    dtype: Any = None

    @nn.compact
    def __call__(self, h: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        f = self.features
        if not self.merge_matmuls:
            dense = lambda name: nn.Dense(f, kernel_init=LecunNormal(),
                                          dtype=self.dtype, name=name)
            z = jax.nn.sigmoid(dense("W_z")(x) + dense("U_z")(h))
            r = jax.nn.sigmoid(dense("W_r")(x) + dense("U_r")(h))
            h_bar = jnp.tanh(dense("W")(x) + dense("U")(r * h))
            return z * h_bar + (1.0 - z) * h
        in_x, in_h = x.shape[-1], h.shape[-1]
        pick = lambda name, shape: _DenseParams(shape, f, name=name)()
        kwz, bwz = pick("W_z", in_x)
        kwr, bwr = pick("W_r", in_x)
        kwn, bwn = pick("W", in_x)
        kuz, buz = pick("U_z", in_h)
        kur, bur = pick("U_r", in_h)
        kun, bun = pick("U", in_h)
        gx = x @ jnp.concatenate([kwz, kwr, kwn], axis=1) + jnp.concatenate(
            [bwz, bwr, bwn]
        )
        gh = h @ jnp.concatenate([kuz, kur], axis=1) + jnp.concatenate([buz, bur])
        z = jax.nn.sigmoid(gx[..., :f] + gh[..., :f])
        r = jax.nn.sigmoid(gx[..., f:2 * f] + gh[..., f:])
        h_bar = jnp.tanh(gx[..., 2 * f:] + (r * h) @ kun + bun)
        return z * h_bar + (1.0 - z) * h


class _DenseParams(nn.Module):
    """Parameter-only stand-in producing the exact tree of an nn.Dense
    ({kernel, bias}) without forcing a separate matmul."""

    in_features: int
    features: int

    @nn.compact
    def __call__(self):
        k = self.param("kernel", LecunNormal(), (self.in_features, self.features))
        b = self.param("bias", nn.initializers.zeros, (self.features,))
        return k, b


class MLP(nn.Module):
    """Plain MLP head body (reference: models/mlp.py:20-46)."""

    out_dim: int
    hidden_dims: Sequence[int] = (32, 16)
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        h = x
        for i, d in enumerate(self.hidden_dims):
            h = self.activation(
                nn.Dense(d, kernel_init=LecunNormal(), name=f"hidden_{i}")(h)
            )
        return nn.Dense(self.out_dim, kernel_init=LecunNormal(), name="out")(h)


class Bilinear(nn.Module):
    """chainer.links.Bilinear: y_k = x1^T W_k x2 (+ V1 x1 + V2 x2 + b).

    (reference NTN head: models/mlp.py:48-73 uses links.Bilinear with the
    default nobias=False -> linear terms included.)
    """

    out_dim: int
    use_linear_terms: bool = True

    @nn.compact
    def __call__(self, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        d1, d2 = x1.shape[-1], x2.shape[-1]
        w = self.param("W", LecunNormal(), (d1, d2, self.out_dim))
        y = jnp.einsum("...i,ijk,...j->...k", x1, w, x2)
        if self.use_linear_terms:
            y = y + nn.Dense(self.out_dim, use_bias=False, name="V1")(x1)
            y = y + nn.Dense(self.out_dim, use_bias=False, name="V2")(x2)
            y = y + self.param("b", nn.initializers.zeros, (self.out_dim,))
        return y
