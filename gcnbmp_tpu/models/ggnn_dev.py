"""GGNN-dev research variants.

Reference: models/ggnn_dev.py (:20-176 — trimmed GGNN caching per-layer
atom states and per-layer readouts, with the final return OVERRIDDEN to
plain sum pooling at :167), plus the update-rule variants:

- fuse (ggnn_dev_fuse.py:71-89):  out = r*h + f*tanh(W1[h‖m]),
  r = sigmoid(W2[h‖m]), f = sigmoid(W3[h‖m])
- gate (ggnn_dev_gate.py:115-119): alpha = sigmoid(W[h‖m]);
  out = (1-alpha)*h + alpha*m
- self_loop (ggnn_dev_self_loop.py:96): m += W_self h, then GRU
- gru: the standard Chainer GRU update (chin_ggnn/ggnn_chin minimal GGNN)

The sum-pool override is kept behind ``sum_pool_readout`` (default True,
as the reference executes); the gated readouts are still computed per
layer into aux['g_list'] exactly like the reference's g_vec_list.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.ggnn import GatedReadout, GGNNMessage
from gcnbmp_tpu.models.layers import (
    ChainerGRUCell,
    EmbedAtomID,
    GraphLinear,
    LecunNormal,
    MAX_ATOMIC_NUM,
)


class GGNNDev(nn.Module):
    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    n_atom_types: int = MAX_ATOMIC_NUM
    concat_hidden: bool = False
    weight_tying: bool = True
    dropout_rate: float = 0.0
    update_variant: str = "gru"  # gru | fuse | gate | self_loop
    sum_pool_readout: bool = True  # the dev override (ggnn_dev.py:167)

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
        messages = [
            GGNNMessage(self.hidden_dim, name=f"update_{i}") for i in range(n_message)
        ]
        if self.update_variant == "self_loop":
            self_loops = [
                GraphLinear(self.hidden_dim, name=f"self_loop_{i}")
                for i in range(n_message)
            ]
        if self.update_variant in ("gru", "self_loop"):
            gru = ChainerGRUCell(self.hidden_dim, name="gru")
        elif self.update_variant == "fuse":
            fuse_z = nn.Dense(self.hidden_dim, kernel_init=LecunNormal(), name="fuse_z")
            fuse_r = nn.Dense(self.hidden_dim, kernel_init=LecunNormal(), name="fuse_r")
            fuse_f = nn.Dense(self.hidden_dim, kernel_init=LecunNormal(), name="fuse_f")
        elif self.update_variant == "gate":
            gates = [
                nn.Dense(self.hidden_dim, kernel_init=LecunNormal(), name=f"gate_{i}")
                for i in range(n_message)
            ]
        else:
            raise ValueError(f"unknown update_variant {self.update_variant!r}")
        n_readout = self.n_layers if self.concat_hidden else 1
        readouts = [
            GatedReadout(self.out_dim, name=f"readout_{i}") for i in range(n_readout)
        ]

        gru_state = jnp.zeros_like(h)
        atoms_list, g_vec_list, g_list = [], [], []
        for step in range(self.n_layers):
            idx = 0 if self.weight_tying else step
            m = messages[idx](h, adj)
            x = jnp.concatenate([h, m], axis=-1)
            if self.update_variant == "gru":
                gru_state = gru(gru_state, x)
                h = gru_state
            elif self.update_variant == "self_loop":
                m = m + self_loops[idx](h)
                x = jnp.concatenate([h, m], axis=-1)
                gru_state = gru(gru_state, x)
                h = gru_state
            elif self.update_variant == "fuse":
                z = jnp.tanh(fuse_z(x))
                r = jax.nn.sigmoid(fuse_r(x))
                f = jax.nn.sigmoid(fuse_f(x))
                rh = r * h
                if self.dropout_rate > 0.0:
                    rh = nn.Dropout(
                        rate=self.dropout_rate, deterministic=deterministic
                    )(rh)
                h = rh + f * z
            else:  # gate
                alpha = jax.nn.sigmoid(gates[idx](x))
                h = (1.0 - alpha) * h + alpha * m
            if self.dropout_rate > 0.0 and self.update_variant != "fuse":
                h = nn.Dropout(rate=self.dropout_rate, deterministic=deterministic)(h)
            ro_idx = step if self.concat_hidden else 0
            g_vec = readouts[ro_idx](h, h0, mask)
            atoms_list.append(h)
            g_vec_list.append(g_vec)
            if self.concat_hidden:
                g_list.append(g_vec)

        aux: Dict[str, Any] = {
            "atoms": h, "h0": h0, "h_list": atoms_list, "g_list": g_vec_list,
        }
        if self.concat_hidden:
            return jnp.concatenate(g_list, axis=-1), aux
        if self.sum_pool_readout:
            hm = h if mask is None else h * mask[..., None]
            return jnp.sum(hm, axis=1), aux
        return g_vec_list[-1], aux
