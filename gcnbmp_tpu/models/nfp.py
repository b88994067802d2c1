"""NFP (Neural Fingerprint) encoder (reference: models/models/nfp.py:15-179).

Degree-conditioned linear updates with sigmoid, softmax-over-channels
readout accumulated across layers; exposes per-atom states in aux
(reference ``get_atom_array``:177).

The reference consumes a plain (B, N, N) adjacency with self-connections
(chainer_chemistry construct_adj_matrix).  For interface uniformity this
module accepts the framework's (B, 4, N, N) edge-type adjacency and
derives ``plain = clip(sum_types, 0, 1) + I`` internally.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from gcnbmp_tpu import nn

from gcnbmp_tpu.models.layers import EmbedAtomID, GraphLinear, MAX_ATOMIC_NUM
from gcnbmp_tpu.models.readouts import NFPReadout


class NFPUpdate(nn.Module):
    out_channels: int
    max_degree: int = 6

    @nn.compact
    def __call__(
        self, h: jnp.ndarray, adj: jnp.ndarray, deg: jnp.ndarray
    ) -> jnp.ndarray:
        """adj: plain (B, N, N); deg: (B, N) int degrees (incl. self)."""
        fv = jnp.einsum("bij,bjc->bic", adj, h)
        out = 0.0
        for d in range(1, self.max_degree + 2):
            cond = (deg == d)[..., None]
            fvd = jnp.where(cond, fv, 0.0)
            out = out + GraphLinear(self.out_channels, name=f"linear_d{d}")(fvd)
        return jax.nn.sigmoid(out)


class NFP(nn.Module):
    out_dim: int
    hidden_dim: int = 16
    n_layers: int = 4
    max_degree: int = 6
    n_atom_types: int = MAX_ATOMIC_NUM
    concat_hidden: bool = False

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
        if adj.ndim == 4:
            plain = jnp.clip(jnp.sum(adj, axis=1), 0.0, 1.0)
        else:
            plain = adj
        n = plain.shape[-1]
        eye = jnp.eye(n, dtype=plain.dtype)[None]
        if mask is not None:
            # self-connections only for real atoms
            plain = plain + eye * mask[:, :, None] * mask[:, None, :]
        else:
            plain = plain + eye
        deg = jnp.sum(plain, axis=1).astype(jnp.int32)  # (B, N), incl. self

        g = 0.0
        g_list = []
        for step in range(self.n_layers):
            h = NFPUpdate(self.hidden_dim, self.max_degree, name=f"update_{step}")(
                h, plain, deg
            )
            dg = NFPReadout(self.out_dim, name=f"readout_{step}")(h, mask)
            g = g + dg
            if self.concat_hidden:
                g_list.append(g)
        aux = {"atoms": h, "h0": None, "h_list": [], "g_list": g_list}
        if self.concat_hidden:
            return jnp.concatenate(g_list, axis=-1), aux
        return g, aux
