"""Link-prediction scoring heads: (left [B,D], right [B,D]) -> logits [B,C].

Reference head family selected by ``--sim-method``
(train_ddi_modify_eval2.py:269-289): hole | ntn | dist-mult | mlp |
symmlp | cosine.  HolE is the paper's head.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import Bilinear, LecunNormal, MLP
from gcnbmp_tpu.ops.circular import circular_correlation_auto


class HolEHead(nn.Module):
    """Circular correlation -> MLP -> logits
    (reference: models/link_prediction/hole.py:53-91).

    The flagship config uses HolE(out_dim=1, hidden_dims=())
    (train_ddi_modify_eval2.py:281-282)."""

    out_dim: int
    hidden_dims: Sequence[int] = (32, 16)
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        h = circular_correlation_auto(left, right)
        return MLP(self.out_dim, self.hidden_dims, self.activation, name="mlp")(h)


class NTNHead(nn.Module):
    """Bilinear tensor layer (k=8 slices) -> MLP
    (reference: models/mlp.py:48-73)."""

    out_dim: int
    ntn_out_dim: int = 8
    hidden_dims: Sequence[int] = (16,)
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        h = Bilinear(self.ntn_out_dim, name="bilinear")(left, right)
        return MLP(self.out_dim, self.hidden_dims, self.activation, name="mlp")(h)


class DistMultHead(nn.Module):
    """Diagonal bilinear -> MLP (reference:
    models/link_prediction/dist_mult.py:17-82 — which materializes
    per-slice diag matrices; here it is just (left*right) @ W, the same
    math without the D x D scatter)."""

    out_dim: int
    dm_out_dim: int = 8
    hidden_dims: Sequence[int] = (16,)
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        w = self.param("W_diag", LecunNormal(), (left.shape[-1], self.dm_out_dim))
        h = (left * right) @ w
        return MLP(self.out_dim, self.hidden_dims, self.activation, name="mlp")(h)


class MLPHead(nn.Module):
    """concat(left, right) -> MLP (reference: models/mlp.py:20-46 used as
    pair head via concatenation in the predictor)."""

    out_dim: int
    hidden_dims: Sequence[int] = (32, 16)
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        h = jnp.concatenate([left, right], axis=-1)
        return MLP(self.out_dim, self.hidden_dims, self.activation, name="mlp")(h)


class SymMLPHead(nn.Module):
    """concat(left+right, left*right) -> MLP — symmetric by construction
    (reference: models/mlp.py:96 SymMLP; the standalone copy at
    models/link_prediction/symmlp.py:11-25 has a missing-import bug the
    reference never exercises)."""

    out_dim: int
    hidden_dims: Sequence[int] = (32, 16)
    activation: Callable = nn.relu

    @nn.compact
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        h = jnp.concatenate([left + right, left * right], axis=-1)
        return MLP(self.out_dim, self.hidden_dims, self.activation, name="mlp")(h)


class CosineHead(nn.Module):
    """Cosine similarity logit (reference: train_binary.py:36 imports
    chainer_chemistry's CosineSimilarity head)."""

    out_dim: int = 1
    eps: float = 1e-8

    @nn.compact
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        num = jnp.sum(left * right, axis=-1, keepdims=True)
        den = jnp.linalg.norm(left, axis=-1, keepdims=True) * jnp.linalg.norm(
            right, axis=-1, keepdims=True
        )
        sim = num / jnp.maximum(den, self.eps)
        if self.out_dim == 1:
            return sim
        return nn.Dense(self.out_dim, kernel_init=LecunNormal(), name="out")(sim)


HEADS = {
    "hole": HolEHead,
    "ntn": NTNHead,
    "dist-mult": DistMultHead,
    "mlp": MLPHead,
    "symmlp": SymMLPHead,
    "cosine": CosineHead,
}
