"""Trainer over the packed compute path: learns the toy task and matches
the padded path's eval metrics (same params tree)."""

import numpy as np
import pytest

from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
from gcnbmp_tpu.data.dataset import PairDataset
from gcnbmp_tpu.train import TrainConfig, Trainer

OXY = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
NO_OXY = ["CC", "CCC", "c1ccccc1", "CCN", "C#N"]


def _toy(n=48, seed=0):
    rng = np.random.default_rng(seed)
    f = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(n):
        if rng.random() < 0.5:
            s1, s2, y = rng.choice(OXY), rng.choice(OXY), 1.0
        else:
            s1 = rng.choice(NO_OXY)
            s2 = rng.choice(OXY) if rng.random() < 0.5 else rng.choice(NO_OXY)
            y = 0.0
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)), np.float32(y))
    return ds


@pytest.mark.parametrize("path", ["packed", "coo"])
def test_packed_training_learns(tmp_path, path):
    cfg = TrainConfig(
        method="ggnn", sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=10,
        early_stop_patience=100, out_dir=str(tmp_path / path),
        snapshot_interval=100, seed=0, compute_path=path, plot_reports=False,
    )
    result = Trainer(cfg, _toy(), val_ds=_toy(seed=1)).fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.8


@pytest.mark.parametrize("method", ["relgcn", "gin", "mpnn"])
def test_coo_training_learns_relgcn_gin(tmp_path, method):
    """RelGCN/GIN ride the packed COO fast path end-to-end (the new
    PackedRelGCN/PackedGIN encoders)."""
    cfg = TrainConfig(
        method=method, sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=10,
        early_stop_patience=100, out_dir=str(tmp_path / method),
        snapshot_interval=100, seed=0, compute_path="coo",
        plot_reports=False,
    )
    result = Trainer(cfg, _toy(), val_ds=_toy(seed=1)).fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.8


def test_scan_mode_relgcn_learns(tmp_path):
    """Scan mode is encoder-agnostic on the packed paths: RelGCN with
    scan_steps=2 trains on the COO layout."""
    cfg = TrainConfig(
        method="relgcn", sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=8,
        early_stop_patience=100, out_dir=str(tmp_path / "scan_relgcn"),
        snapshot_interval=100, seed=0, compute_path="coo", scan_steps=2,
        plot_reports=False, eval_train=True,
    )
    result = Trainer(cfg, _toy(), val_ds=_toy(seed=1)).fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.8


def test_coo_coattention_training_learns(tmp_path):
    """Co-attention rides the COO packed path end-to-end (train + eval)."""
    cfg = TrainConfig(
        method="ggnn", sim_method="hole", attn="nie", fp_hidden_dim=8,
        fp_out_dim=8, conv_layers=2, batch_size=8, learning_rate=5e-3,
        epochs=10, early_stop_patience=100,
        out_dir=str(tmp_path / "coo_attn"), snapshot_interval=100, seed=0,
        compute_path="coo", plot_reports=False,
    )
    result = Trainer(cfg, _toy(), val_ds=_toy(seed=1)).fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.8


def test_packed_incompatible_config_raises(tmp_path):
    cfg = TrainConfig(
        method="ggnn", attn="para", compute_path="packed",
        out_dir=str(tmp_path / "x"),
    )
    with pytest.raises(ValueError, match="co-attention"):
        Trainer(cfg, _toy(8), None).fit()


@pytest.mark.parametrize("path", ["packed", "coo"])
def test_scan_matches_sequential(tmp_path, path):
    """scan_steps=2 (two train steps per lax.scan dispatch) produces the
    same parameters as the plain per-step path — same seed, same
    shuffle order, 48 pairs / batch 8 -> 6 steps/epoch = 3 full chunks."""
    import jax

    def run(scan_steps, out):
        cfg = TrainConfig(
            method="ggnn", sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
            conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=3,
            early_stop_patience=100, out_dir=str(tmp_path / out),
            snapshot_interval=100, seed=0, compute_path=path,
            plot_reports=False, scan_steps=scan_steps, eval_train=False,
        )
        return Trainer(cfg, _toy()).fit()

    seq = run(0, "seq")
    scan = run(2, "scan")
    leaves_a = jax.tree_util.tree_leaves(seq["state"].params)
    leaves_b = jax.tree_util.tree_leaves(scan["state"].params)
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-6)
    # per-step losses identical too (scan returns them stacked)
    np.testing.assert_allclose(
        [e["main/loss"] for e in seq["log"]],
        [e["main/loss"] for e in scan["log"]], rtol=1e-5, atol=1e-7,
    )


def test_reuse_packs_training_learns(tmp_path):
    """cfg.reuse_packs: epoch-1 packed batches are reused with
    batch-level reshuffle (VERDICT r3 #2 — removes the per-epoch host
    pack cost); training still learns the toy task and the cache is
    populated exactly once."""
    cfg = TrainConfig(
        method="ggnn", sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=10,
        early_stop_patience=100, out_dir=str(tmp_path / "reuse"),
        snapshot_interval=100, seed=0, compute_path="coo",
        reuse_packs=True, plot_reports=False,
    )
    trainer = Trainer(cfg, _toy(), val_ds=_toy(seed=1))
    result = trainer.fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.8
    # 48 pairs / batch 8 -> 6 batches, cached once (not re-packed)
    assert len(trainer._pack_cache) == 6


def test_reuse_packs_with_scan(tmp_path):
    """reuse_packs composes with scan mode (the production sustained
    pipeline: cached packs -> scan chunks)."""
    cfg = TrainConfig(
        method="ggnn", sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=10,
        early_stop_patience=100, out_dir=str(tmp_path / "reuse_scan"),
        snapshot_interval=100, seed=0, compute_path="coo", scan_steps=2,
        reuse_packs=True, plot_reports=False,
    )
    trainer = Trainer(cfg, _toy(), val_ds=_toy(seed=1))
    result = trainer.fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.8


def test_coo_coattention_scan_training_learns(tmp_path):
    """Round 5: single-device co-attention + scan mode end-to-end (the
    config the coattn_scan sweep measures — the Trainer already wires
    compact_coattn_arrays through scan_chunk_iterator)."""
    import numpy as np

    from gcnbmp_tpu.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu.data.dataset import PairDataset
    from gcnbmp_tpu.train import TrainConfig, Trainer

    f = GGNNFeaturizer()
    rng = np.random.default_rng(5)
    ds = PairDataset()
    oxy = ["CCO", "CC(=O)O", "OCCO", "COC"]
    nox = ["CC", "CCC", "c1ccccc1", "CCN"]
    for _ in range(96):
        if rng.random() < 0.5:
            s1, s2, y = rng.choice(oxy), rng.choice(oxy), 1.0
        else:
            s1 = rng.choice(nox)
            s2 = rng.choice(oxy if rng.random() < 0.5 else nox)
            y = 0.0
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)),
                  np.float32(y))
    cfg = TrainConfig(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=16,
        learning_rate=5e-3, epochs=8, early_stop_patience=100,
        compute_path="coo", attn="nie", scan_steps=2,
        compute_dtype="bfloat16",
        out_dir=str(tmp_path / "coattn_scan"), snapshot_interval=100,
        seed=0,
    )
    result = Trainer(cfg, ds, None).fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/roc_auc"] > 0.9


@pytest.mark.parametrize("scan_steps", [0, 2])
def test_step_log_records_every_dispatch(tmp_path, scan_steps):
    """TrainConfig.step_log: one wall time per train dispatch (a scan
    chunk counts once) and one loss per step in the epoch's log entry."""
    cfg = TrainConfig(
        method="ggnn", sim_method="hole", fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, epochs=1, out_dir=str(tmp_path),
        seed=0, compute_path="coo", scan_steps=scan_steps, step_log=True,
        plot_reports=False, eval_train=False,
    )
    entry = Trainer(cfg, _toy(), None).fit()["log"][-1]
    steps = len(_toy()) // 8
    dispatches = steps // scan_steps if scan_steps else steps
    assert len(entry["step_losses"]) == dispatches * max(scan_steps, 1)
    assert len(entry["dispatch_s"]) == dispatches
    assert all(t > 0 for t in entry["dispatch_s"])
    assert np.all(np.isfinite(entry["step_losses"]))
