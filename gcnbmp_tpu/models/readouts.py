"""Shared readout modules.

- CommonGGNNReadout: chainer_chemistry-style gated readout where BOTH
  gate and value layers consume [h, h0] (reference:
  models/readout/ggnn_readout.py:13-59, also vendored in models/gin.py:
  9-55).  Distinct from the GGNN-core readout (models/ggnn.py:333-341)
  whose value layer sees h only — both exist in the reference.
- Set2Set: order-invariant LSTM attention pooling (reference:
  models/readout/set2set.py:14-57).
- MPNNReadout: Set2Set x processing_steps + 2-layer MLP (reference:
  models/readout/mpnn_readout.py:38-66).
- NFPReadout: softmax-over-channels accumulation (reference:
  models/models/nfp.py:65-91).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import GraphLinear, LecunNormal


def identity(x):
    return x


class CommonGGNNReadout(nn.Module):
    out_dim: int
    nobias: bool = False
    activation: Callable = identity
    activation_agg: Callable = identity

    @nn.compact
    def __call__(
        self,
        h: jnp.ndarray,
        h0: Optional[jnp.ndarray] = None,
        mask: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        h1 = jnp.concatenate([h, h0], axis=-1) if h0 is not None else h
        g1 = jax.nn.sigmoid(GraphLinear(self.out_dim, use_bias=not self.nobias, name="i")(h1))
        g2 = self.activation(GraphLinear(self.out_dim, use_bias=not self.nobias, name="j")(h1))
        g = g1 * g2
        if mask is not None:
            g = g * mask[..., None]
        return self.activation_agg(jnp.sum(g, axis=-2))


class Set2Set(nn.Module):
    """q_star(0)=0; per step: q = LSTM(q_star); a = softmax(h . q) over
    atoms; r = sum a*h; q_star = [q, r].  Returns (B, 2*ch)."""

    channels: int
    processing_steps: int = 3

    @nn.compact
    def __call__(
        self, h: jnp.ndarray, mask: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        b, n, ch = h.shape
        cell = nn.OptimizedLSTMCell(self.channels, name="lstm")
        carry = cell.initialize_carry(jax.random.PRNGKey(0), (b, 2 * ch))
        carry = jax.tree.map(jnp.zeros_like, carry)  # deterministic zero init
        q_star = jnp.zeros((b, 2 * ch), h.dtype)
        for _ in range(self.processing_steps):
            carry, q = cell(carry, q_star)  # q: (B, ch)
            e = jnp.einsum("bnc,bc->bn", h, q)[..., None]  # (B, N, 1)
            if mask is not None:
                e = jnp.where(mask[..., None] > 0, e, -1e9)
            a = jax.nn.softmax(e, axis=1)
            if mask is not None:
                a = a * mask[..., None]
            r = jnp.sum(a * h, axis=1)  # (B, ch)
            q_star = jnp.concatenate([q, r], axis=-1)
        return q_star


class MPNNReadout(nn.Module):
    out_dim: int
    hidden_dim: int
    processing_steps: int = 3

    @nn.compact
    def __call__(
        self, h: jnp.ndarray, mask: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        g = Set2Set(self.hidden_dim, self.processing_steps, name="set2set")(h, mask)
        g = nn.relu(nn.Dense(self.hidden_dim, kernel_init=LecunNormal(), name="linear1")(g))
        return nn.Dense(self.out_dim, kernel_init=LecunNormal(), name="linear2")(g)


class NFPReadout(nn.Module):
    out_dim: int

    @nn.compact
    def __call__(
        self, h: jnp.ndarray, mask: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        i = GraphLinear(self.out_dim, name="output_weight")(h)
        i = jax.nn.softmax(i, axis=-1)  # softmax along channel axis
        if mask is not None:
            i = i * mask[..., None]
        return jnp.sum(i, axis=-2)
