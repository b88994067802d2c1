"""GIN encoder (reference: models/gin.py:131-226).

Per layer: neighbor sum (adjacency summed over edge types) + self, then
2-layer MLP with ReLU and dropout (reference GINUpdate:58-128); readout is
the chainer_chemistry gated readout over [h, h0] with is_real_node
masking (reference models/gin.py:9-55).

Quirk note: the reference's forward iterates ``range(n_message_layers)``
which is 1 under weight tying (models/gin.py:205), silently collapsing a
"4-layer tied" GIN to one layer.  Here the loop runs ``n_layers`` steps
as documented; set ``quirk_tied_single_layer=True`` to reproduce the
reference literally.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import EmbedAtomID, GraphLinear, MAX_ATOMIC_NUM
from gcnbmp_tpu.models.readouts import CommonGGNNReadout, identity


class GINUpdate(nn.Module):
    hidden_dim: int
    dropout_ratio: float = 0.5
    # jnp.bfloat16 -> matmul operands bf16, f32 accumulate (params f32)
    dtype: Any = None

    @nn.compact
    def __call__(
        self, h: jnp.ndarray, adj: jnp.ndarray, deterministic: bool = True
    ) -> jnp.ndarray:
        a = jnp.sum(adj, axis=1)  # (B, N, N)
        if self.dtype is not None:
            a = a.astype(self.dtype)
            h = h.astype(self.dtype)
        fv = jax.lax.dot_general(
            a, h, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        sum_h = fv + h.astype(jnp.float32)
        new_h = nn.relu(GraphLinear(self.hidden_dim, dtype=self.dtype,
                                    name="linear_g1")(sum_h))
        new_h = GraphLinear(self.hidden_dim, dtype=self.dtype,
                            name="linear_g2")(new_h)
        if self.dropout_ratio > 0.0:
            new_h = nn.Dropout(rate=self.dropout_ratio, deterministic=deterministic)(new_h)
        return nn.relu(new_h)


class GIN(nn.Module):
    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    n_atom_types: int = MAX_ATOMIC_NUM
    dropout_ratio: float = 0.5
    concat_hidden: bool = False
    weight_tying: bool = True
    activation: Callable = identity
    quirk_tied_single_layer: bool = False

    @nn.compact
    def __call__(
        self,
        atoms: jnp.ndarray,
        adj: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, Dict[str, Any]]:
        if jnp.issubdtype(atoms.dtype, jnp.integer):
            h = EmbedAtomID(self.n_atom_types, self.hidden_dim, name="embed")(atoms)
        else:
            h = atoms
        h0 = h
        n_message = 1 if self.weight_tying else self.n_layers
        updates = [
            GINUpdate(self.hidden_dim, self.dropout_ratio, name=f"update_{i}")
            for i in range(n_message)
        ]
        n_readout = self.n_layers if self.concat_hidden else 1
        readouts = [
            CommonGGNNReadout(
                self.out_dim, activation=self.activation,
                activation_agg=self.activation, name=f"readout_{i}",
            )
            for i in range(n_readout)
        ]
        steps = n_message if self.quirk_tied_single_layer else self.n_layers
        g_list = []
        for step in range(steps):
            h = updates[0 if self.weight_tying else step](h, adj, deterministic)
            if self.concat_hidden:
                g_list.append(readouts[step](h, h0, mask))
        aux = {"atoms": h, "h0": h0, "h_list": [], "g_list": g_list}
        if self.concat_hidden:
            return jnp.concatenate(g_list, axis=-1), aux
        return readouts[0](h, h0, mask), aux
