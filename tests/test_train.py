"""End-to-end training tests on a tiny synthetic task (the sample200-style
smoke run of SURVEY §4c): label = 1 iff both molecules contain oxygen —
learnable from atom identities alone."""

import os

import numpy as np
import pytest

from gcnbmp_tpu.chem import mol_from_smiles, GGNNFeaturizer
from gcnbmp_tpu.data.dataset import PairDataset
from gcnbmp_tpu.train import TrainConfig, Trainer
from gcnbmp_tpu.train.metrics import binary_metrics, multilabel_metrics

OXY = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC", "OC1CCCCC1"]
NO_OXY = ["CC", "CCC", "c1ccccc1", "CCN", "C#N", "C1CCCCC1"]


def _toy_dataset(n_pairs=48, seed=0):
    rng = np.random.default_rng(seed)
    f = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(n_pairs):
        if rng.random() < 0.5:
            s1, s2, y = rng.choice(OXY), rng.choice(OXY), 1.0
        else:
            s1 = rng.choice(NO_OXY)
            s2 = rng.choice(OXY) if rng.random() < 0.5 else rng.choice(NO_OXY)
            y = 0.0
        ds.append(f(mol_from_smiles(s1)), f(mol_from_smiles(s2)), np.float32(y))
    return ds


@pytest.mark.parametrize("sim_method", ["hole", "ntn"])
def test_train_loss_decreases(tmp_path, sim_method):
    ds = _toy_dataset()
    cfg = TrainConfig(
        method="ggnn", sim_method=sim_method, fp_hidden_dim=8, fp_out_dim=8,
        conv_layers=2, batch_size=8, learning_rate=5e-3, epochs=15,
        early_stop_patience=100, out_dir=str(tmp_path / "out"),
        snapshot_interval=100, seed=0,
    )
    result = Trainer(cfg, ds, val_ds=_toy_dataset(seed=1)).fit()
    log = result["log"]
    assert log[-1]["main/loss"] < log[0]["main/loss"]
    assert log[-1]["train/accuracy"] > 0.7
    assert log[-1]["train/roc_auc"] > 0.8


def test_checkpoint_roundtrip(tmp_path):
    ds = _toy_dataset(n_pairs=16)
    cfg = TrainConfig(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=8,
        epochs=2, out_dir=str(tmp_path / "out"), snapshot_interval=1, seed=0,
        early_stop_patience=100,
    )
    trainer = Trainer(cfg, ds, val_ds=ds)
    result = trainer.fit()
    state = result["state"]

    from gcnbmp_tpu.train.checkpoints import restore_checkpoint, save_checkpoint

    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    template = trainer._init_state()
    restored = restore_checkpoint(path, template)
    assert restored.epoch == state.epoch
    assert restored.step == state.step
    import jax

    for a, b in zip(
        jax.tree_util.tree_leaves(state.params),
        jax.tree_util.tree_leaves(restored.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_msgpack_fallback(tmp_path):
    # the one checkpoint format: a plain .npz that loads without pickle
    import jax

    from gcnbmp_tpu.train import checkpoints

    ds = _toy_dataset(n_pairs=16)
    cfg = TrainConfig(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=8,
        epochs=1, out_dir=str(tmp_path / "out"), snapshot_interval=100,
        seed=0, early_stop_patience=100,
    )
    trainer = Trainer(cfg, ds, val_ds=ds)
    state = trainer.fit()["state"]
    path = str(tmp_path / "ckpt_msgpack")
    checkpoints.save_checkpoint(path, state)
    with np.load(path + ".npz", allow_pickle=False) as data:
        assert len(data.files) == len(jax.tree_util.tree_leaves(
            checkpoints._state_to_tree(state)))
    restored = checkpoints.restore_checkpoint(path, trainer._init_state())
    assert restored.epoch == state.epoch
    for a, b in zip(
        jax.tree_util.tree_leaves(state.params),
        jax.tree_util.tree_leaves(restored.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_debug_checks_checkify(tmp_path):
    # clean run passes under checkify; a poisoned batch raises (SURVEY §5.2)
    import jax
    import jax.numpy as jnp

    from gcnbmp_tpu.data.dataset import make_batch
    from gcnbmp_tpu.models import set_up_predictor
    from gcnbmp_tpu.train.loop import build_optimizer, make_train_step

    ds = _toy_dataset(n_pairs=8)
    cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                      batch_size=8, epochs=1, seed=0)
    pred = set_up_predictor(method="ggnn", fp_hidden_dim=8, fp_out_dim=8,
                            conv_layers=2, sim_method="hole")
    b = make_batch(ds, list(range(8)))
    rng = jax.random.PRNGKey(0)
    params = pred.init(rng, jnp.asarray(b.atoms1), jnp.asarray(b.adj1),
                       jnp.asarray(b.atoms2), jnp.asarray(b.adj2),
                       jnp.asarray(b.mask1), jnp.asarray(b.mask2))["params"]
    opt, _ = build_optimizer(cfg, steps_per_epoch=1)
    opt_state = opt.init(params)
    step = make_train_step(pred, opt, debug_checks=True)
    labels = jnp.asarray(b.labels, jnp.float32)
    out = step(params, opt_state, b.atoms1, b.adj1, b.atoms2, b.adj2,
               b.mask1, b.mask2, (), labels, rng)
    assert np.isfinite(float(out[2]))
    bad = jnp.asarray(b.adj1).at[0].set(jnp.nan)
    with pytest.raises(Exception, match="nan"):
        step(params, opt_state, b.atoms1, bad, b.atoms2, b.adj2,
             b.mask1, b.mask2, (), labels, rng)


def test_resume_continues(tmp_path):
    ds = _toy_dataset(n_pairs=16)
    out = str(tmp_path / "out")
    cfg = TrainConfig(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=8,
        epochs=2, out_dir=out, snapshot_interval=2, seed=0,
        early_stop_patience=100,
    )
    Trainer(cfg, ds, val_ds=ds).fit()
    cfg2 = TrainConfig(
        fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=8,
        epochs=4, out_dir=out, snapshot_interval=2, seed=0,
        early_stop_patience=100, resume=os.path.join(out, "snapshot_epoch_2"),
    )
    result = Trainer(cfg2, ds, val_ds=ds).fit()
    assert result["state"].epoch == 4


def test_binary_metrics_values():
    logits = np.array([3.0, -3.0, 2.0, -1.0])
    labels = np.array([1, 0, 1, 1])
    m = binary_metrics(logits, labels)
    assert m["accuracy"] == 0.75
    assert 0.0 <= m["roc_auc"] <= 1.0
    assert m["f1"] == pytest.approx(2 * 2 / (2 * 2 + 0 + 1))


def test_multilabel_metrics_skips_degenerate_columns():
    logits = np.array([[2.0, 1.0], [-2.0, 1.0]])
    labels = np.array([[1, 1], [0, 1]])  # col 1 is all-positive -> skipped for auc
    m = multilabel_metrics(logits, labels)
    assert m["roc_auc"] == 1.0
    assert np.isfinite(m["accuracy"])


def test_multilabel_metrics_per_class_breakdown():
    logits = np.array([[2.0, 1.0], [-2.0, 1.0], [3.0, -1.0]])
    labels = np.array([[1, 1], [0, 1], [1, 0]])
    m = multilabel_metrics(logits, labels, class_names=["tA", "tB"])
    pc = m["per_class"]
    assert set(pc) == {"tA", "tB"}
    assert pc["tA"]["roc_auc"] == 1.0
    assert pc["tA"]["support"] == 2
    assert pc["tB"]["support"] == 2
    # class means unchanged by requesting the breakdown
    m2 = multilabel_metrics(logits, labels)
    assert m2["roc_auc"] == m["roc_auc"] and "per_class" not in m2


def test_exponential_shift_schedule():
    from gcnbmp_tpu.train.schedules import exponential_shift_schedule

    sched = exponential_shift_schedule(1e-3, (10, 20), steps_per_epoch=5, rate=0.5)
    assert float(sched(0)) == pytest.approx(1e-3)
    assert float(sched(49)) == pytest.approx(1e-3)   # epoch 9
    assert float(sched(50)) == pytest.approx(5e-4)   # epoch 10 boundary
    assert float(sched(100)) == pytest.approx(2.5e-4)


def test_cyclical_schedules():
    from gcnbmp_tpu.train.schedules import cyclical_schedule

    tri = cyclical_schedule(1e-4, 1e-3, step_size=10, mode="triangular")
    assert float(tri(0)) == pytest.approx(1e-4)
    assert float(tri(10)) == pytest.approx(1e-3)    # peak of first cycle
    assert float(tri(20)) == pytest.approx(1e-4)    # back to base
    tri2 = cyclical_schedule(1e-4, 1e-3, step_size=10, mode="triangular2")
    assert float(tri2(30)) == pytest.approx(1e-4 + (1e-3 - 1e-4) / 2)  # halved amp
    expr = cyclical_schedule(1e-4, 1e-3, step_size=10, mode="exp_range",
                             gamma=0.99)
    assert float(expr(10)) < float(tri(10))  # decayed peak


def test_all_presets_train_one_epoch(tmp_path):
    """Every BASELINE preset instantiates and completes an epoch on the
    toy task (class_num adjusted for the multilabel preset)."""
    import dataclasses

    from gcnbmp_tpu.train.config import PRESETS

    ds = _toy_dataset(n_pairs=16)
    for name, preset in PRESETS.items():
        cfg = dataclasses.replace(
            preset, epochs=1, batch_size=8, fp_hidden_dim=8, fp_out_dim=8,
            conv_layers=2, class_num=1, out_dir=str(tmp_path / name),
            snapshot_interval=100, early_stop_patience=100,
            plot_reports=False, eval_train=False, augment=False,
            # the production/x86 presets scan 10 steps per dispatch —
            # more than this toy epoch has batches (the Trainer
            # rejects that, by design)
            scan_steps=min(preset.scan_steps, 2),
        )
        result = Trainer(cfg, ds, None).fit()
        assert np.isfinite(result["log"][-1]["main/loss"]), name
