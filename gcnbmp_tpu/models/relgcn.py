"""RelGCN encoder (reference: models/relgcn.py:31-73,
models/update/relgcn_update.py:12-44).

Per layer: ``h' = tanh(W_self h + sum_e A_e (h W_e))`` with per-edge-type
linear weights, then a chainer_chemistry-style gated readout
(nobias=True, tanh).  Optional symmetric in-degree rescale of the
adjacency (reference rescale_adj, models/relgcn.py:20-28).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import EmbedAtomID, GraphLinear, MAX_ATOMIC_NUM
from gcnbmp_tpu.models.readouts import CommonGGNNReadout
from gcnbmp_tpu.ops.aggregate import edge_type_aggregate

NUM_EDGE_TYPE = 4


def rescale_adj(adj: jnp.ndarray) -> jnp.ndarray:
    """adj / in-degree, matching reference rescale_adj: degree summed over
    (edge_type, src) per target column."""
    num_neighbor = jnp.sum(adj, axis=(1, 2))  # (B, N)
    inv = 1.0 / jnp.where(num_neighbor != 0, num_neighbor, 1.0)
    return adj * inv[:, None, None, :]


class RelGCNUpdate(nn.Module):
    out_channels: int
    # jnp.bfloat16 -> matmul operands bf16, f32 accumulate (params f32)
    dtype: Any = None

    @nn.compact
    def __call__(self, h: jnp.ndarray, adj: jnp.ndarray) -> jnp.ndarray:
        b, n, _ = h.shape
        hs = GraphLinear(self.out_channels, dtype=self.dtype, name="self")(h)
        m = GraphLinear(self.out_channels * NUM_EDGE_TYPE, dtype=self.dtype,
                        name="edge")(h)
        # reference layout: (mb, node, out_ch, edge) -> (mb, edge, node, out_ch)
        m = m.reshape(b, n, self.out_channels, NUM_EDGE_TYPE)
        m = jnp.transpose(m, (0, 3, 1, 2))
        if self.dtype is not None:
            adj = adj.astype(self.dtype)
        return hs + edge_type_aggregate(adj, m)


class RelGCN(nn.Module):
    """Uniform encoder interface: (atoms, adj, mask) -> (g, aux).

    ch_list defaults to [16, 128, 64] (reference models/relgcn.py:37);
    ``hidden_dim``/``n_layers`` adapt the uniform factory args: when
    ch_list is None it becomes [hidden_dim] + [hidden_dim]*n_layers.
    """

    out_dim: int = 64
    hidden_dim: int = 16
    n_layers: int = 2
    ch_list: Optional[Tuple[int, ...]] = None
    n_atom_types: int = MAX_ATOMIC_NUM
    scale_adj: bool = False
    # When True, float inputs are taken as already-embedded atom states
    # (the GGNN float-path contract) instead of DrugFP-style raw features
    # fed through embed_linear.  Saliency clones the encoder with this set
    # so it can differentiate w.r.t. the EmbedAtomID output
    # (reference eval_saliency_map.py:34-39 is encoder-agnostic the same way).
    pre_embedded: bool = False

    @nn.compact
    def __call__(
        self,
        atoms: jnp.ndarray,
        adj: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, Dict[str, Any]]:
        chs = list(self.ch_list) if self.ch_list else [self.hidden_dim] * (self.n_layers + 1)
        if jnp.issubdtype(atoms.dtype, jnp.integer):
            h = EmbedAtomID(self.n_atom_types, chs[0], name="embed")(atoms)
        elif self.pre_embedded:
            h = atoms
        else:
            h = GraphLinear(chs[0], name="embed_linear")(atoms)
        if self.scale_adj:
            adj = rescale_adj(adj)
        for i in range(len(chs) - 1):
            h = jnp.tanh(RelGCNUpdate(chs[i + 1], name=f"conv_{i}")(h, adj))
        g = CommonGGNNReadout(
            self.out_dim, nobias=True, activation=jnp.tanh, name="readout"
        )(h, None, mask)
        return g, {"atoms": h, "h0": None, "h_list": [], "g_list": []}
