"""Slot-table gather with a gather-only VJP (no scatter in the backward).

``jnp.take(flat, slots)`` — the op both the dense Set2Set atom table
(models/packed.PackedSet2Set) and the co-attention atom tables
(models/packed.PackedCoattnPairPredictor) are built on — autodiffs to a
scatter-add over the table's rows: the dense-Set2Set table backward
alone scatter-adds num_mols*n_max rows per step.

This module removes the scatter by exploiting the packed-layout
invariant (data/packing: molecules occupy CONTIGUOUS flat slot runs and
each real slot belongs to exactly one masked-in table entry): the
transpose of an injective contiguous gather is itself a gather —

    grad_flat[p] = grad_table[row(m), p - start(m)]   (m = mol_id[p])

with ``start(m) = slots[row(m), 0]`` read straight off the forward's
own slot table.  Both sides of the VJP are pure gathers + elementwise
masking; no scatter, no sort, no segment op.

Correctness REQUIRES the two invariants above; they hold for every
table produced by data/packing.molecule_slot_table and
models/packed._device_slot_table (asserted in tests/test_slotgather.py,
including grad parity against the plain-take form).  No reference
counterpart — the reference's readout/co-attention batching is padded
per-molecule (models/readout/set2set.py:14-57,
models/coattention/*), so this layout problem does not exist there.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def gather_slot_table(flat, slots, amask, ids, mol_row):
    """``flat[slots] * amask[..., None]`` with a gather-only backward.

    Args:
        flat: (N, C) node states over the flattened packed layout.
        slots: (R, n_max) int32 flat indices; row r holds molecule
            ``m``'s atoms at ``slots[r, j] = start(m) + j`` for every
            masked-in j (contiguous runs; pad entries arbitrary but
            masked out).
        amask: (R, n_max) float mask, 1 on real atoms.
        ids: (N,) int32 molecule id per flat slot (padding slots carry
            an id >= mol_row.shape[0] - 1, i.e. the sentinel row).
        mol_row: (num_mols + 1,) int32 mapping molecule id -> table row
            r, or -1 for molecules not in this table (e.g. the other
            side of a pair); the final entry is the padding sentinel
            and must be -1.

    Returns:
        (R, n_max, C) gathered, masked atom table — bit-identical to
        ``jnp.take(flat, slots.reshape(-1), axis=0).reshape(R, n_max, -1)
        * amask[..., None]``.
    """
    # The index arrays ride through the custom_vjp as f32 so their
    # cotangents are ordinary zero floats: float0 cotangents for integer
    # primals break shard_map's transpose ("Unexpected XLA sharding
    # override" — hit by the edgeshard co-attention path).  f32 is exact
    # for indices < 2^24; the packed layouts are orders of magnitude
    # below that (P < 2^15 tiles already bounds flat slots < 2^22).
    if flat.shape[0] >= (1 << 24) or slots.size >= (1 << 24):
        raise ValueError("gather_slot_table: index range exceeds exact-f32")
    sg = jax.lax.stop_gradient
    return _gather_slot_table_f(flat, sg(jnp.asarray(slots, jnp.float32)),
                                sg(amask), sg(jnp.asarray(ids, jnp.float32)),
                                sg(jnp.asarray(mol_row, jnp.float32)))


@jax.custom_vjp
def _gather_slot_table_f(flat, slots_f, amask, ids_f, mol_row_f):
    r, n_max = slots_f.shape
    slots = slots_f.astype(jnp.int32)
    atoms = jnp.take(flat, slots.reshape(-1), axis=0).reshape(r, n_max, -1)
    return atoms * amask[..., None]


def _fwd(flat, slots_f, amask, ids_f, mol_row_f):
    out = _gather_slot_table_f(flat, slots_f, amask, ids_f, mol_row_f)
    proto = jnp.zeros((0,), flat.dtype)  # dtype carrier (a dtype object
    # itself is not a valid residual leaf)
    return out, (slots_f, amask, ids_f, mol_row_f, flat.shape[0], proto)


def _bwd(res, g):
    slots_f, amask, ids_f, mol_row_f, n, proto = res
    flat_dtype = proto.dtype
    slots = slots_f.astype(jnp.int32)
    ids = ids_f.astype(jnp.int32)
    mol_row = mol_row_f.astype(jnp.int32)
    r_rows, n_max = slots.shape
    pos = jnp.arange(n, dtype=jnp.int32)
    m = jnp.clip(ids, 0, mol_row.shape[0] - 1)
    row = jnp.take(mol_row, m)                      # (N,) table row or -1
    row_c = jnp.clip(row, 0, r_rows - 1)
    start = jnp.take(slots[:, 0], row_c)            # start(m) per flat slot
    off = pos - start
    ok = (row >= 0) & (off >= 0) & (off < n_max)
    idx = jnp.clip(row_c * n_max + jnp.clip(off, 0, n_max - 1),
                   0, r_rows * n_max - 1)
    # exact transpose of ``atoms * amask``: scale the gathered cotangent
    # by the slot's own amask value (0 on pad entries, so this also
    # zeroes slots whose table entry is masked out; exact for fractional
    # masks, not just binary ones)
    aval = jnp.take(amask.reshape(-1), idx)
    gf = g.reshape(r_rows * n_max, -1)
    grad_flat = jnp.where(ok[:, None],
                          jnp.take(gf, idx, axis=0) * aval[:, None], 0)
    return (grad_flat.astype(flat_dtype), jnp.zeros_like(slots_f),
            jnp.zeros_like(amask), jnp.zeros_like(ids_f),
            jnp.zeros_like(mol_row_f))


_gather_slot_table_f.defvjp(_fwd, _bwd)


def identity_mol_row(num_mols: int) -> jnp.ndarray:
    """mol_row for a table with one row per molecule in id order
    (the dense Set2Set case): [0, 1, ..., num_mols-1, -1]."""
    return jnp.concatenate([
        jnp.arange(num_mols, dtype=jnp.int32),
        jnp.full((1,), -1, jnp.int32),
    ])


def side_mol_row(index: jnp.ndarray, num_mols: int) -> jnp.ndarray:
    """mol_row for a per-pair table over one side of the pair batch
    (the co-attention case): molecule ``index[i]`` maps to row i,
    every other molecule (the other side) to -1.  One (B,)-row int32
    scatter — negligible next to the (B*n_max, C) scatter-add it
    replaces in the backward.

    REQUIRES ``index`` to be injective over entries whose table row has
    any masked-in atom: the ``.at[index].set`` is last-write-wins, so a
    molecule id appearing in two real rows would silently route both
    rows' cotangents to one row and drop the other's gradient.  Every
    packer satisfies this (pair mol ids are globally unique per batch;
    padded pairs reuse the sentinel id but are fully masked), and the
    co-attention array builders assert it host-side in debug mode
    (data/packing.check_side_index_injective)."""
    base = jnp.full((num_mols + 1,), -1, jnp.int32)
    return base.at[index].set(jnp.arange(index.shape[0], dtype=jnp.int32))
