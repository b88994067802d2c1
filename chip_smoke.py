#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU, in one process.

    python chip_smoke.py                # phases a-e on one card
    python chip_smoke.py --four-cards   # graph-sharded training, 4 cards vs 1

Phases (each failure ends the script with a non-zero exit code):

a. device: JAX's first device must be a GPU (the script never falls back
   to the CPU); prints its kind, the device count, and the card's name
   and power limit from nvidia-smi.
b. train, evaluate, predict: the ``ggnn_hole_production`` preset (GGNN,
   8 untied layers at h=32, HolE head, COO packed path, bf16 matmuls,
   scan_steps=10, B=2048) trains one epoch of the committed
   dataset/synth546/drug splits through ``gcnbmp_tpu.cli.train.main``;
   then ``cli.evaluate.main`` scores the test split and
   ``cli.predict.main`` a few hundred of its pairs from the run directory.
   The loss must be finite and the last scan chunk's mean below the
   first's.
c. agreement with the plain reference: on test pairs at full width, the
   packed COO path against the padded float32 modules under ``highest``
   matmul precision, on the trained parameters (tolerances below).
d. HolE crossover: fwd+bwd time of ops/circular's rfft and circulant
   matmul forms at D in {16, 32, 64}, B=2048.
e. the last line of stdout is the JSON result
   ``{"ok": true, "device": {"platform", "kind", "count"}}``.

``--four-cards`` runs only the multi-device check: the production preset
with ``multi_device=True`` (the edge-sharded COO path over a flat
``("graph",)`` mesh of every visible card) for a few scan chunks, against
the same batches on one card.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "dataset", "synth546", "drug")
PRESET = "ggnn_hole_production"

# Phase (c) tolerances, on 2048 test pairs with the trained parameters.
# f32 path vs f32 reference, both at "highest": only the summation order
# differs (on-device scatters and segment sums use atomics on the GPU, and
# packed tiles sum in another order than the padded batch).  Observed on
# H100 80GB HBM3 cards (400 W and 700 W limits): 3.6e-6 and 3.8e-6; the
# bound leaves 5x for the run-to-run order of the atomics.
F32_MAX_ABS_LOGIT = 2e-5
# bf16 production path (bf16 operands, f32 accumulation, XLA default
# precision) vs the f32 reference: each bf16 operand rounds at 2^-9
# relative, compounded through 8 message/GRU layers, on logits of order
# 1-10 (max |logit| 6.0-7.3).  Training itself is not bit-reproducible
# on the GPU (atomics), so each run checks other trained parameters.
# Observed over four runs: max 0.099, 0.099, 0.117, 0.164 (an extreme
# of 2048 samples, so it wanders); mean 0.019, 0.019, 0.018, 0.034;
# AUROC gap 2.2e-4, 2.1e-4, 9.9e-4, 5.6e-4.  Bounds: ~3x the largest
# observed max and mean; the AUROC bound, the quality that matters, is
# the issue's default, 5x the largest observed gap.
BF16_MAX_ABS_LOGIT = 0.5
BF16_MEAN_ABS_LOGIT = 0.1
BF16_MAX_AUROC_GAP = 5e-3
AGREEMENT_PAIRS = 2048

# --four-cards tolerances.  (1) One step from the same parameters and
# batch: the sharded loss and gradient against one card's, in the
# bf16-robust terms tests/test_parallel.py uses (bf16 partial sums reduce
# in another order).  (2) The Trainer over 3 scan chunks: Adam's first
# steps turn that reduction-order noise into sign-sized updates
# (observed on four H100 80GB HBM3: step-1 loss 1.4605 vs 1.4756), and the
# lr 2e-3 warm-up spike (losses up to 5-8 at steps 2-3) separates the
# trajectories, which then rejoin: over the last chunk the mean |loss
# gap| was 0.019 and every leaf's update cosine >= 0.971.
FOUR_CARD_MAX_LOSS_REL_GAP = 1e-3
FOUR_CARD_MIN_GRAD_COSINE = 0.999
FOUR_CARD_MAX_GRAD_GAP_RMS = 0.15
FOUR_CARD_MAX_LAST_CHUNK_LOSS_GAP = 0.05
FOUR_CARD_MIN_UPDATE_COSINE = 0.95
FOUR_CARD_PAIRS = 30720  # x2 with swap augmentation: 30 steps, 3 chunks


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device(expect_count=None) -> dict:
    import jax

    from gcnbmp_tpu.runtime import gpu_name_and_power_limit, require_gpu

    devices = require_gpu()
    if expect_count is not None and len(devices) < expect_count:
        raise RuntimeError(
            f"{len(devices)} GPU(s) visible, this phase needs {expect_count}")
    dev = devices[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
    say(f"# a. device: {info['kind']} x{info['count']} "
        f"(jax {jax.__version__})")
    return info


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _write_rows(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _call_cli(main, argv) -> str:
    """Run a CLI ``main`` in this process; return what it printed."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"{main.__module__} exited {rc}")
    return buf.getvalue()


def phase_train_eval_predict(out, data=DATA, preset=PRESET,
                             n_predict=300) -> dict:
    import jax
    import numpy as np

    from gcnbmp_tpu.cli import evaluate as cli_eval
    from gcnbmp_tpu.cli import predict as cli_predict
    from gcnbmp_tpu.cli import train as cli_train

    run = os.path.join(out, "run")
    train_csv = os.path.join(data, "ddi_drug_train.csv")
    valid_csv = os.path.join(data, "ddi_drug_valid.csv")
    test_csv = os.path.join(data, "ddi_drug_test.csv")

    t0 = time.perf_counter()
    _call_cli(cli_train.main, [
        "--train", train_csv, "--val", valid_csv, "--preset", preset,
        "--epochs", "1", "--out", run, "--step-log"])
    train_wall = time.perf_counter() - t0
    with open(os.path.join(run, "config.json")) as f:
        scan = max(1, json.load(f)["scan_steps"])
    with open(os.path.join(run, "log.json")) as f:
        entry = json.load(f)[-1]
    losses = np.asarray(entry["step_losses"], np.float64)
    dispatch = np.asarray(entry["dispatch_s"], np.float64)
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses.tolist()}")
    first, last = losses[:scan].mean(), losses[-scan:].mean()
    say(f"# b. train: {len(losses)} steps in {len(dispatch)} dispatches; "
        f"first chunk mean loss {first:.5f}, last {last:.5f}")
    if not last < first:
        raise RuntimeError(
            f"loss did not fall: first chunk {first:.5f}, last {last:.5f}")
    steady = dispatch[2:] if len(dispatch) > 3 else dispatch[1:]
    step_ms = float(np.median(steady)) / scan * 1e3
    stats = jax.devices()[0].memory_stats() or {}
    facts = {
        "train_wall_s": train_wall,
        "first_dispatch_s (compile + one chunk; set-up)": float(dispatch[0]),
        "steady_step_ms (median over later chunks)": step_ms,
        "steady_chunks": int(len(steady)),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "val_roc_auc": entry.get("val/roc_auc"),
    }

    ev = os.path.join(out, "eval")
    printed = _call_cli(cli_eval.main, [
        "--test", test_csv, "--run", run, "--checkpoint", "final",
        "--batch-size", "2048", "--out", ev])
    metrics = json.loads(printed.strip().splitlines()[-1])
    facts["test_roc_auc"] = metrics["roc_auc"]
    if not np.isfinite(metrics["roc_auc"]):
        raise RuntimeError(f"test AUROC is not finite: {metrics}")

    rows = _read_rows(test_csv)[:n_predict]
    small = os.path.join(out, "predict_in.csv")
    _write_rows(small, rows)
    preds_csv = os.path.join(out, "predictions.csv")
    _call_cli(cli_predict.main, [
        "--input", small, "--run", run, "--checkpoint", "final",
        "--out", preds_csv])
    probs = np.asarray([float(r["prob"]) for r in _read_rows(preds_csv)])
    if len(probs) != len(rows) or not np.all((probs >= 0) & (probs <= 1)):
        raise RuntimeError(
            f"predict: {len(probs)} probabilities for {len(rows)} pairs, "
            f"range [{probs.min()}, {probs.max()}]")
    facts["predicted_pairs"] = int(len(probs))
    for k, v in facts.items():
        say(f"# b. {k}: {v}")
    return {"run": run, "test_csv": test_csv, **facts}


def _load_run(run, ds, checkpoint="final"):
    """(TrainConfig, params, padded reference predictor) of a run dir."""
    import dataclasses

    from gcnbmp_tpu.train import TrainConfig, Trainer
    from gcnbmp_tpu.train.checkpoints import restore_checkpoint

    with open(os.path.join(run, "config.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    trainer = Trainer(dataclasses.replace(cfg, augment=False, balance=False,
                                          scan_steps=1), ds, None)
    state = restore_checkpoint(os.path.join(run, checkpoint),
                               trainer._init_state())
    return cfg, state.params, trainer.predictor


def phase_agreement(run, test_csv, n_pairs=AGREEMENT_PAIRS,
                    batch_size=512) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from gcnbmp_tpu.data.parsers import CSVPairParser
    from gcnbmp_tpu.eval.agreement import packed_and_reference_logits
    from gcnbmp_tpu.train.metrics import roc_auc

    ds = CSVPairParser().parse(test_csv).dataset
    ds = ds.subset(range(min(n_pairs, len(ds))))
    cfg, params, ref_pred = _load_run(run, ds)
    out = {"pairs": len(ds)}

    f32, ref, labels = packed_and_reference_logits(
        cfg, params, ds, ref_pred, batch_size, path_precision="highest")
    f32_tf32, _, _ = packed_and_reference_logits(
        cfg, params, ds, ref_pred, batch_size)
    bf16, _, _ = packed_and_reference_logits(
        cfg, params, ds, ref_pred, batch_size, compute_dtype=jnp.bfloat16)
    out["f32_highest_max_abs_logit"] = float(np.max(np.abs(f32 - ref)))
    out["f32_default_precision_max_abs_logit"] = float(
        np.max(np.abs(f32_tf32 - ref)))
    out["bf16_max_abs_logit"] = float(np.max(np.abs(bf16 - ref)))
    out["bf16_mean_abs_logit"] = float(np.mean(np.abs(bf16 - ref)))
    out["bf16_p99_abs_logit"] = float(np.percentile(np.abs(bf16 - ref), 99))
    out["reference_max_abs_logit"] = float(np.max(np.abs(ref)))
    auc_ref, auc_bf16 = roc_auc(labels, ref), roc_auc(labels, bf16)
    out["auroc_reference"], out["auroc_bf16"] = auc_ref, auc_bf16
    for k, v in out.items():
        say(f"# c. {k}: {v}")
    checks = [
        (out["f32_highest_max_abs_logit"] <= F32_MAX_ABS_LOGIT,
         f"f32 path vs reference > {F32_MAX_ABS_LOGIT}"),
        (out["bf16_max_abs_logit"] <= BF16_MAX_ABS_LOGIT,
         f"bf16 path vs reference > {BF16_MAX_ABS_LOGIT}"),
        (out["bf16_mean_abs_logit"] <= BF16_MEAN_ABS_LOGIT,
         f"bf16 mean gap > {BF16_MEAN_ABS_LOGIT}"),
        (abs(auc_bf16 - auc_ref) <= BF16_MAX_AUROC_GAP,
         f"bf16 AUROC gap > {BF16_MAX_AUROC_GAP}"),
    ]
    failed = [msg for ok, msg in checks if not ok]
    if failed:
        raise RuntimeError("agreement failed: " + "; ".join(failed))
    return out


def phase_hole_crossover(dims=(16, 32, 64), batch=2048, iters=500,
                         repeats=3) -> dict:
    """Device time of one HolE fwd+bwd per form: ``iters`` chained
    evaluations inside one jitted ``lax.scan`` (a carried scalar keeps
    them sequential), so host dispatch is amortized away; best of
    ``repeats`` timed calls."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gcnbmp_tpu.ops.circular import (
        circular_correlation,
        circular_correlation_matmul,
        circular_correlation_reference,
    )

    out = {}
    rng = np.random.default_rng(0)
    for d in dims:
        a = jnp.asarray(rng.normal(size=(batch, d)), jnp.float32)
        b = jnp.asarray(rng.normal(size=(batch, d)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(batch, d)), jnp.float32)
        ref = np.asarray(circular_correlation_reference(a, b))
        for name, form in (("rfft", circular_correlation),
                           ("matmul", circular_correlation_matmul)):
            got = np.asarray(jax.jit(form)(a, b))
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
            grad = jax.grad(lambda x, y, f=form: jnp.sum(f(x, y) * w),
                            argnums=(0, 1))

            @jax.jit
            def chained(x, y, grad=grad):
                def body(c, _):
                    gx, gy = grad(x + c, y)
                    return c + 1e-9 * (gx[0, 0] + gy[0, 0]), None
                return jax.lax.scan(body, jnp.float32(0), None,
                                    length=iters)[0]

            jax.block_until_ready(chained(a, b))
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                jax.block_until_ready(chained(a, b))
                best = min(best, time.perf_counter() - t0)
            out[f"D{d}_{name}_us"] = best / iters * 1e6
        say(f"# d. HolE fwd+bwd B={batch} D={d} (device, in-jit loop): "
            f"rfft {out[f'D{d}_rfft_us']:.2f} us, matmul "
            f"{out[f'D{d}_matmul_us']:.2f} us")
    return out


def _sharded_grad_parity(ds, cfg, mesh) -> dict:
    """One production-config step at shared initial parameters: the
    edge-sharded COO loss and gradients against the single-card ones."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gcnbmp_tpu.data.packing import (
        estimate_coo_capacities,
        pack_pair_dataset_coo,
    )
    from gcnbmp_tpu.models.packed import coo_batch_args, make_packed_predictor
    from gcnbmp_tpu.parallel.edgeshard import (
        make_edgeshard_coo_loss,
        shard_packed_coo_batch,
    )
    from gcnbmp_tpu.train.loop import sigmoid_cross_entropy

    pred = make_packed_predictor(
        fp_hidden_dim=cfg.fp_hidden_dim, fp_out_dim=cfg.fp_out_dim,
        conv_layers=cfg.conv_layers, weight_tying=cfg.weight_tying,
        sim_method=cfg.sim_method, coo=True, compute_dtype=jnp.bfloat16,
        adj_dtype=jnp.bfloat16)
    num_tiles, cap = estimate_coo_capacities([ds], cfg.batch_size)
    coo = pack_pair_dataset_coo(ds, list(range(cfg.batch_size)),
                                num_tiles=num_tiles, edge_capacity=cap)
    args = tuple(jnp.asarray(a) for a in coo_batch_args(coo))
    y = jnp.asarray(coo.labels)
    params = pred.init(jax.random.PRNGKey(cfg.seed), *args)["params"]

    def single(p):
        logits = pred.apply({"params": p}, *args)
        return sigmoid_cross_entropy(jnp.reshape(logits, y.shape), y)

    sharded_loss = make_edgeshard_coo_loss(pred, mesh, axis="graph")
    sharded_args = shard_packed_coo_batch(coo, mesh, axis="graph")
    l1, g1 = jax.jit(jax.value_and_grad(single))(params)
    l4, g4 = jax.jit(jax.value_and_grad(
        lambda p: sharded_loss(p, *sharded_args)))(params)
    cos, gap = [], []
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g4)):
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        cos.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)
                                  + 1e-30)))
        gap.append(float(np.max(np.abs(a - b))
                         / (np.sqrt(np.mean(a ** 2)) + 1e-12)))
    return {"loss_rel_gap": abs(float(l4) - float(l1)) / abs(float(l1)),
            "min_grad_cosine": min(cos), "max_grad_gap_over_rms": max(gap)}


def phase_four_cards(out, data=DATA, preset=PRESET,
                     n_pairs=FOUR_CARD_PAIRS) -> dict:
    """The production preset graph-sharded over every visible card vs
    the same batches on one card (same seed -> same shuffles and packs):
    one step's gradients, then the Trainer over a few scan chunks."""
    import dataclasses

    import jax
    import numpy as np

    from gcnbmp_tpu.data.parsers import CSVPairParser
    from gcnbmp_tpu.train import PRESETS, Trainer

    ds = CSVPairParser().parse(os.path.join(data, "ddi_drug_train.csv"))
    ds = ds.dataset.subset(range(n_pairs))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("graph",))
    facts = {"devices_sharded": len(jax.devices())}
    facts.update(_sharded_grad_parity(ds, PRESETS[preset], mesh))
    results = {}
    for name, multi in (("one_card", False), ("sharded", True)):
        cfg = dataclasses.replace(
            PRESETS[preset], epochs=1, multi_device=multi, step_log=True,
            eval_train=False, plot_reports=False,
            out_dir=os.path.join(out, name))
        t0 = time.perf_counter()
        res = Trainer(cfg, ds, None).fit()
        results[name] = {
            "params": jax.device_get(res["state"].params),
            "losses": np.asarray(res["log"][-1]["step_losses"]),
            "wall_s": time.perf_counter() - t0,
        }
    one, shard = results["one_card"], results["sharded"]
    if not (np.all(np.isfinite(one["losses"]))
            and np.all(np.isfinite(shard["losses"]))):
        raise RuntimeError("non-finite loss in the four-card comparison")
    scan = PRESETS[preset].scan_steps
    # what training did to each leaf: the update from the shared initial
    # parameters, compared by cosine similarity
    cfg0 = dataclasses.replace(PRESETS[preset],
                               out_dir=os.path.join(out, "init"))
    init = jax.device_get(Trainer(cfg0, ds, None)._init_state().params)
    cosines = []
    for p0, a, b in zip(jax.tree_util.tree_leaves(init),
                        jax.tree_util.tree_leaves(one["params"]),
                        jax.tree_util.tree_leaves(shard["params"])):
        da = (np.asarray(a, np.float64) - np.asarray(p0, np.float64)).ravel()
        db = (np.asarray(b, np.float64) - np.asarray(p0, np.float64)).ravel()
        cosines.append(float(da @ db / (np.linalg.norm(da) * np.linalg.norm(db)
                                         + 1e-30)))
    facts.update({
        "steps": int(len(one["losses"])),
        "step0_loss_gap": float(abs(one["losses"][0] - shard["losses"][0])),
        "last_chunk_mean_abs_loss_gap": float(np.mean(np.abs(
            one["losses"][-scan:] - shard["losses"][-scan:]))),
        "min_update_cosine": min(cosines),
        "first_last_loss_one_card": [float(one["losses"][0]),
                                     float(one["losses"][-1])],
        "first_last_loss_sharded": [float(shard["losses"][0]),
                                    float(shard["losses"][-1])],
        "wall_s_one_card (incl. compile)": one["wall_s"],
        "wall_s_sharded (incl. compile)": shard["wall_s"],
    })
    for k, v in facts.items():
        say(f"# four-cards. {k}: {v}")
    checks = [
        (facts["loss_rel_gap"] <= FOUR_CARD_MAX_LOSS_REL_GAP, "step loss"),
        (facts["min_grad_cosine"] >= FOUR_CARD_MIN_GRAD_COSINE,
         "gradient cosine"),
        (facts["max_grad_gap_over_rms"] <= FOUR_CARD_MAX_GRAD_GAP_RMS,
         "gradient gap"),
        (facts["last_chunk_mean_abs_loss_gap"]
         <= FOUR_CARD_MAX_LAST_CHUNK_LOSS_GAP, "last-chunk loss gap"),
        (facts["min_update_cosine"] >= FOUR_CARD_MIN_UPDATE_COSINE,
         "update cosine"),
    ]
    failed = [msg for ok, msg in checks if not ok]
    if failed:
        raise RuntimeError("four-card comparison failed: " + ", ".join(failed))
    return facts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card graph-sharded comparison")
    p.add_argument("--out", default=os.path.join(REPO, "results", "chip_smoke"),
                   help="directory for the run, evaluation and predictions")
    args = p.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.WARNING)
    from gcnbmp_tpu.runtime import enable_compile_cache, gpu_name_and_power_limit

    info = phase_device(expect_count=4 if args.four_cards else None)
    say(f"# cache: {enable_compile_cache()}")
    os.makedirs(args.out, exist_ok=True)
    if args.four_cards:
        phase_four_cards(args.out)
    else:
        b = phase_train_eval_predict(args.out)
        phase_agreement(b["run"], b["test_csv"])
        phase_hole_crossover()
    say(gpu_name_and_power_limit())
    say(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
