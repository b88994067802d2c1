"""Packed supergraph tests: packing invariants + padded/packed parity
(same weights, same molecules -> identical embeddings and logits)."""

import jax
import jax.numpy as jnp
import numpy as np

from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset, make_batch
from gcnbmp_tpu.data.packing import (
    TILE,
    estimate_tiles,
    pack_pair_dataset_batch,
)
from gcnbmp_tpu.models import set_up_predictor
from gcnbmp_tpu.models.packed import make_packed_predictor

SMILES = [
    "CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C=O", "CCN(CC)CC",
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O",
]


def _dataset(n_pairs=6):
    f = GGNNFeaturizer()
    rng = np.random.default_rng(0)
    ds = PairDataset()
    for i in range(n_pairs):
        s1 = SMILES[int(rng.integers(len(SMILES)))]
        s2 = SMILES[int(rng.integers(len(SMILES)))]
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)),
                  np.float32(rng.integers(0, 2)))
    return ds


def test_packing_invariants():
    ds = _dataset()
    packed = pack_pair_dataset_batch(ds, list(range(len(ds))))
    assert packed.num_mols == 2 * len(ds)
    # every molecule's atoms present exactly once
    total_atoms = sum(g.num_atoms for g in ds.graphs1) + sum(
        g.num_atoms for g in ds.graphs2
    )
    assert int(packed.node_mask.sum()) == total_atoms
    # mol_id ascends within each tile (padding slots carry num_mols, the
    # max); global sortedness across tiles is NOT an invariant (and the
    # segment_sum no longer claims it — models/packed._segment_mol_sum)
    assert np.all(np.diff(packed.mol_id, axis=1) >= 0)
    # real mol ids ascend across tiles in tile order
    real_per_tile = [
        packed.mol_id[p][packed.mol_id[p] < packed.num_mols]
        for p in range(packed.num_tiles)
    ]
    last = -1
    for ids_ in real_per_tile:
        if len(ids_) == 0:
            continue
        assert int(ids_.min()) > last
        last = int(ids_.max())
    # edges preserved
    total_edges = sum(g.num_edges for g in ds.graphs1) + sum(
        g.num_edges for g in ds.graphs2
    )
    assert packed.num_edges == total_edges
    # pair indices cover all molecules
    assert sorted(packed.left_index.tolist() + packed.right_index.tolist()) == list(
        range(packed.num_mols)
    )


def test_estimate_coo_capacities_covers_fragmentation():
    """Regression: molecules that pack 2-per-tile with 33% slot waste
    (e.g. ~43 atoms) must not overflow the estimated tile bound — the
    bound runs the real FFD packer, not an occupancy estimate."""
    from gcnbmp_tpu.chem.featurize import MolGraph
    from gcnbmp_tpu.data.packing import (
        estimate_coo_capacities,
        pack_pair_dataset_coo,
    )

    def mol(n):  # path graph with n atoms
        src = np.arange(n - 1, dtype=np.int32)
        return MolGraph(
            atom_ids=np.full((n,), 6, np.int32),
            edge_src=np.concatenate([src, src + 1]),
            edge_dst=np.concatenate([src + 1, src]),
            edge_type=np.zeros((2 * (n - 1),), np.int32),
        )

    ds = PairDataset()
    for _ in range(16):
        ds.append(mol(43), mol(43), np.float32(1))
    num_tiles, edge_capacity = estimate_coo_capacities([ds], 16)
    # must not raise (the occupancy bound alone would give too few tiles)
    pack_pair_dataset_coo(ds, list(range(16)), num_tiles=num_tiles,
                          edge_capacity=edge_capacity)

    # fill-covered tail: dataset smaller than the batch size
    small = PairDataset()
    for _ in range(3):
        small.append(mol(43), mol(43), np.float32(1))
    nt, ec = estimate_coo_capacities([small], 16)
    idx = [0, 1, 2] + [0] * 13  # 13 fill copies
    pack_pair_dataset_coo(small, idx, num_tiles=nt, edge_capacity=ec)


def test_estimate_tiles_fixed_shape():
    ds = _dataset()
    sizes = [g.num_atoms for g in ds.graphs1] + [g.num_atoms for g in ds.graphs2]
    p = estimate_tiles(sizes)
    packed = pack_pair_dataset_batch(ds, list(range(len(ds))), num_tiles=p)
    assert packed.num_tiles == p


def test_packed_padded_parity():
    """Same weights, same molecules: packed forward == padded forward."""
    ds = _dataset()
    padded = make_batch(ds, list(range(len(ds))))
    pred = set_up_predictor(
        method="ggnn", fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
        weight_tying=False, sim_method="hole",
    )
    variables = pred.init(
        jax.random.PRNGKey(0),
        jnp.asarray(padded.atoms1), jnp.asarray(padded.adj1),
        jnp.asarray(padded.atoms2), jnp.asarray(padded.adj2),
        jnp.asarray(padded.mask1), jnp.asarray(padded.mask2),
    )
    logits_padded, aux = pred.apply(
        variables,
        jnp.asarray(padded.atoms1), jnp.asarray(padded.adj1),
        jnp.asarray(padded.atoms2), jnp.asarray(padded.adj2),
        jnp.asarray(padded.mask1), jnp.asarray(padded.mask2),
        return_aux=True,
    )

    packed = pack_pair_dataset_batch(ds, list(range(len(ds))))
    ppred = make_packed_predictor(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=3, weight_tying=False,
        sim_method="hole",
    )
    logits_packed = ppred.apply(
        variables,  # same params!
        jnp.asarray(packed.atom_ids), jnp.asarray(packed.adj),
        jnp.asarray(packed.mol_id), jnp.asarray(packed.node_mask),
        jnp.asarray(packed.left_index), jnp.asarray(packed.right_index),
    )
    np.testing.assert_allclose(
        np.asarray(logits_packed), np.asarray(logits_padded), rtol=1e-4, atol=1e-5
    )


def test_packed_padded_parity_layer_aggregator():
    """JKNet layer aggregation rides the packed layout (round 3): same
    weights produce the padded encoder's logits for the per-node
    aggregator modes.  RNN/attn modes see PADDING slots as extra rows,
    but those rows are masked at the readout and the per-node recurrence
    never mixes rows, so parity holds exactly."""
    ds = _dataset()
    padded = make_batch(ds, list(range(len(ds))))
    packed = pack_pair_dataset_batch(ds, list(range(len(ds))))
    for mode in ("gru", "concat", "max-pool", "attn"):
        pred = set_up_predictor(
            method="ggnn", fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
            weight_tying=False, sim_method="hole", layer_aggregator=mode,
        )
        variables = pred.init(
            jax.random.PRNGKey(0),
            jnp.asarray(padded.atoms1), jnp.asarray(padded.adj1),
            jnp.asarray(padded.atoms2), jnp.asarray(padded.adj2),
            jnp.asarray(padded.mask1), jnp.asarray(padded.mask2),
        )
        logits_padded = pred.apply(
            variables,
            jnp.asarray(padded.atoms1), jnp.asarray(padded.adj1),
            jnp.asarray(padded.atoms2), jnp.asarray(padded.adj2),
            jnp.asarray(padded.mask1), jnp.asarray(padded.mask2),
        )
        ppred = make_packed_predictor(
            fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
            weight_tying=False, sim_method="hole", layer_aggregator=mode,
        )
        logits_packed = ppred.apply(
            variables,  # same params
            jnp.asarray(packed.atom_ids), jnp.asarray(packed.adj),
            jnp.asarray(packed.mol_id), jnp.asarray(packed.node_mask),
            jnp.asarray(packed.left_index), jnp.asarray(packed.right_index),
        )
        np.testing.assert_allclose(
            np.asarray(logits_packed), np.asarray(logits_padded),
            rtol=1e-4, atol=1e-5, err_msg=mode,
        )


def test_packed_padded_parity_relgcn_gin():
    """Packed RelGCN/GIN produce the padded encoders' logits from the
    same weights (the new packed fast-path encoders, models/packed.py
    PackedRelGCN/PackedGIN)."""
    import pytest

    ds = _dataset()
    padded = make_batch(ds, list(range(len(ds))))
    packed = pack_pair_dataset_batch(ds, list(range(len(ds))))
    for method in ("relgcn", "gin", "nfp", "mpnn"):
        pred = set_up_predictor(
            method=method, fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
            weight_tying=False, sim_method="hole",
        )
        variables = pred.init(
            jax.random.PRNGKey(0),
            jnp.asarray(padded.atoms1), jnp.asarray(padded.adj1),
            jnp.asarray(padded.atoms2), jnp.asarray(padded.adj2),
            jnp.asarray(padded.mask1), jnp.asarray(padded.mask2),
        )
        logits_padded = pred.apply(
            variables,
            jnp.asarray(padded.atoms1), jnp.asarray(padded.adj1),
            jnp.asarray(padded.atoms2), jnp.asarray(padded.adj2),
            jnp.asarray(padded.mask1), jnp.asarray(padded.mask2),
        )
        ppred = make_packed_predictor(
            fp_hidden_dim=8, fp_out_dim=8, conv_layers=3, weight_tying=False,
            sim_method="hole", method=method,
        )
        logits_packed = ppred.apply(
            variables,  # same params
            jnp.asarray(packed.atom_ids), jnp.asarray(packed.adj),
            jnp.asarray(packed.mol_id), jnp.asarray(packed.node_mask),
            jnp.asarray(packed.left_index), jnp.asarray(packed.right_index),
        )
        np.testing.assert_allclose(
            np.asarray(logits_packed), np.asarray(logits_padded),
            rtol=1e-4, atol=1e-5, err_msg=method,
        )


def test_compact_wire_decode_non_power_of_two_tile():
    """Regression: the compact wire decode masks src/dst with the full
    sbits-wide lane, not (tile-1) — they differ for non-power-of-two
    tile sizes (e.g. 100 -> lane 127 vs 99)."""
    from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
    from gcnbmp_tpu.models.packed import (
        compact_coo_arrays,
        coo_batch_args,
    )

    ds = _dataset()
    coo = pack_pair_dataset_coo(ds, list(range(len(ds))), tile=100)
    plain = make_packed_predictor(fp_hidden_dim=8, fp_out_dim=8,
                                  conv_layers=2, coo=True)
    compact = make_packed_predictor(fp_hidden_dim=8, fp_out_dim=8,
                                    conv_layers=2, coo=True, compact=True)
    args_plain = tuple(jnp.asarray(a) for a in coo_batch_args(coo))
    v = plain.init(jax.random.PRNGKey(0), *args_plain)
    l1 = plain.apply(v, *args_plain)
    args_compact = tuple(jnp.asarray(a) for a in compact_coo_arrays(coo))
    l2 = compact.apply(v, *args_compact)
    np.testing.assert_allclose(np.asarray(l2), np.asarray(l1), rtol=1e-5)


def test_packed_grads_finite():
    ds = _dataset()
    packed = pack_pair_dataset_batch(ds, list(range(len(ds))))
    ppred = make_packed_predictor(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2)
    args = (
        jnp.asarray(packed.atom_ids), jnp.asarray(packed.adj),
        jnp.asarray(packed.mol_id), jnp.asarray(packed.node_mask),
        jnp.asarray(packed.left_index), jnp.asarray(packed.right_index),
    )
    variables = ppred.init(jax.random.PRNGKey(0), *args)
    y = jnp.asarray(packed.labels)

    def loss(p):
        logits = ppred.apply({"params": p}, *args)
        return jnp.mean(
            jnp.maximum(logits[:, 0], 0) - logits[:, 0] * y
            + jnp.log1p(jnp.exp(-jnp.abs(logits[:, 0])))
        )

    grads = jax.grad(loss)(variables["params"])
    assert all(
        np.all(np.isfinite(np.asarray(g))) for g in jax.tree_util.tree_leaves(grads)
    )


def test_coo_validate_catches_corruption():
    """PackedCOOBatch.validate + the in-jit checkify twin both catch
    out-of-bounds edges that adj_from_coo's mode='drop' scatter would
    silently discard."""
    import dataclasses

    import pytest
    from jax.experimental import checkify

    from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
    from gcnbmp_tpu.ops.aggregate import coo_bounds_check

    ds = _dataset(6)
    coo = pack_pair_dataset_coo(ds, list(range(6)))
    coo.validate()  # clean batch passes

    # corrupt one real edge's destination beyond the tile
    bad_dst = coo.e_dst.copy()
    idx = int(np.flatnonzero(coo.e_mask > 0)[0])
    bad_dst[idx] = TILE + 3
    bad = dataclasses.replace(coo, e_dst=bad_dst)
    with pytest.raises(ValueError, match="e_dst"):
        bad.validate()

    def run(e_dst):
        coo_bounds_check(
            jnp.asarray(coo.e_tile), jnp.asarray(coo.e_type),
            jnp.asarray(coo.e_src), jnp.asarray(e_dst),
            jnp.asarray(coo.e_mask),
            num_tiles=coo.num_tiles, tile=TILE,
        )

    err, _ = checkify.checkify(run)(coo.e_dst)
    err.throw()  # clean: no error
    err, _ = checkify.checkify(run)(bad_dst)
    with pytest.raises(Exception, match="e_dst out of bounds"):
        err.throw()

    # masked (padding) edges may point anywhere: mask the bad edge out
    masked = coo.e_mask.copy()
    masked[idx] = 0.0
    ok = dataclasses.replace(bad, e_mask=masked)
    ok.validate()


def test_trainer_debug_checks_smoke(tmp_path):
    from gcnbmp_tpu.train import TrainConfig, Trainer

    ds = _dataset(16)
    cfg = TrainConfig(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=8,
        epochs=2, compute_path="coo", debug_checks=True,
        out_dir=str(tmp_path / "o"), snapshot_interval=100,
        early_stop_patience=100, seed=0,
    )
    result = Trainer(cfg, ds, None).fit()
    assert np.isfinite(result["log"][-1]["main/loss"])


def test_packed_bf16_compute_close_to_f32():
    """compute_dtype=bf16 (matmul operands bf16, f32 accumulation) stays
    numerically close to the f32 path."""
    import jax.numpy as jnp

    ds = _dataset()
    packed = pack_pair_dataset_batch(ds, list(range(len(ds))))
    args = (
        jnp.asarray(packed.atom_ids), jnp.asarray(packed.adj),
        jnp.asarray(packed.mol_id), jnp.asarray(packed.node_mask),
        jnp.asarray(packed.left_index), jnp.asarray(packed.right_index),
    )
    for method in ("ggnn", "relgcn", "gin"):
        f32 = make_packed_predictor(
            fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
            weight_tying=False, sim_method="hole", method=method,
        )
        variables = f32.init(jax.random.PRNGKey(0), *args)
        ref = np.asarray(f32.apply(variables, *args))
        bf16 = make_packed_predictor(
            fp_hidden_dim=8, fp_out_dim=8, conv_layers=3,
            weight_tying=False, sim_method="hole", method=method,
            compute_dtype=jnp.bfloat16,
        )
        got = np.asarray(bf16.apply(variables, *args))  # same params
        assert np.all(np.isfinite(got)), method
        np.testing.assert_allclose(got, ref, rtol=0.1, atol=0.05,
                                   err_msg=method)
