"""Edge-type-conditioned message aggregation (the GGNN hot loop).

Semantics (reference: models/ggnn.py:222-242): per edge type e,
``m_e = adj_e @ (h W_e)`` then sum over the 4 types:

    out[b, i, h] = sum_e sum_j adj[b, e, i, j] * msg[b, e, j, h]

The contraction is expressed as a single batched matmul with contraction length ``4*N`` — we flatten the
edge-type axis into the contraction instead of looping over 4 small
matmuls:

    out[b, i, h] = sum_{(e,j)} adj[b, i, (e,j)] * msg[b, (e,j), h]

which is exactly ``adj_flat (B, N, 4N) @ msg_flat (B, 4N, H)``.  For
N=128 tiles this is one (128, 512) x (512, H) matmul per graph-tile —
no wasted flops relative to the 4-way loop and a 4x longer (better)
contraction dimension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def edge_type_aggregate(adj: jnp.ndarray, msg: jnp.ndarray) -> jnp.ndarray:
    """Aggregate per-edge-type messages.

    Args:
        adj: (B, E, N, N) one-hot-ish adjacency (E edge types).
        msg: (B, E, N, H) per-type transformed node features (h @ W_e).

    Returns:
        (B, N, H) summed neighbor messages.
    """
    b, e, n, _ = adj.shape
    h = msg.shape[-1]
    # (B, N, E*N) @ (B, E*N, H) -> (B, N, H)
    adj_flat = jnp.transpose(adj, (0, 2, 1, 3)).reshape(b, n, e * n)
    msg_flat = msg.reshape(b, e * n, h)
    return jax.lax.dot_general(
        adj_flat,
        msg_flat,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )


def edge_type_aggregate_reference(adj: jnp.ndarray, msg: jnp.ndarray) -> jnp.ndarray:
    """Direct transcription of the reference loop (for tests)."""
    return jnp.einsum("beij,bejh->bih", adj, msg)


def adj_from_coo(
    e_tile: jnp.ndarray,
    e_type: jnp.ndarray,
    e_src: jnp.ndarray,
    e_dst: jnp.ndarray,
    e_mask: jnp.ndarray,
    num_tiles: int,
    tile: int,
    num_edge_types: int = 4,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Materialize the dense (P, E, T, T) tile adjacency on device from a
    padded COO edge list (one scatter-add; padding edges carry mask 0 so
    they contribute nothing wherever their indices point).

    This keeps the host->device transfer at ~#edges ints per batch instead
    of the P*4*T*T dense tensor — the adjacency itself only ever exists in
    HBM.  No reference counterpart (its batching is host-side pad-to-max,
    chainer_chemistry concat_mols); input path per SURVEY §7.1.

    The scatter uses FLATTENED 1-D indices (one scatter-add into a flat
    buffer instead of a 4-D scatter).  Flat
    'drop' only drops indices beyond the whole array, so per-component
    bounds (e.g. e_src >= tile) are NOT individually dropped — padding
    edges are harmless regardless (mask 0 adds zero wherever it lands),
    and malformed real edges are caught by coo_bounds_check / the host
    batch validator.  Requires 4*num_tiles*tile^2 < 2^31 (the same
    P < 2^15 bound as the compact wire encoding).
    """
    idx = ((e_tile * num_edge_types + e_type) * tile + e_src) * tile + e_dst
    flat = jnp.zeros((num_tiles * num_edge_types * tile * tile,), dtype)
    flat = flat.at[idx].add(e_mask.astype(dtype), mode="drop")
    return flat.reshape(num_tiles, num_edge_types, tile, tile)


def coo_bounds_check(
    e_tile: jnp.ndarray,
    e_type: jnp.ndarray,
    e_src: jnp.ndarray,
    e_dst: jnp.ndarray,
    e_mask: jnp.ndarray,
    num_tiles: int,
    tile: int,
    num_edge_types: int = 4,
):
    """In-jit checkify twin of PackedCOOBatch.validate: asserts every real
    edge's indices are in bounds BEFORE adj_from_coo's mode='drop' scatter
    can silently discard them.  Usage:

        err, _ = checkify.checkify(lambda: coo_bounds_check(...))()
        err.throw()

    Composable under jit/scan via jax.experimental.checkify (the
    framework's device-side sanitizer; SURVEY §5.2 — the reference has
    no native code and nothing to sanitize)."""
    from jax.experimental import checkify

    real = e_mask > 0

    def in_bounds(x, hi):
        return jnp.where(real, (x >= 0) & (x < hi), True).all()

    checkify.check(in_bounds(e_tile, num_tiles), "e_tile out of bounds")
    checkify.check(in_bounds(e_type, num_edge_types), "e_type out of bounds")
    checkify.check(in_bounds(e_src, tile), "e_src out of bounds")
    checkify.check(in_bounds(e_dst, tile), "e_dst out of bounds")
