#!/usr/bin/env python
"""Training CLI — the equivalent of the reference's entry scripts
(train_ddi_modify_eval2.py / train_binary.py / the multi-label x37
trainer) behind one typed-config command.

Examples:
    python train.py --train train.csv --val val.csv --preset ggnn_hole_binary
    python train.py --train t.csv --method ggnn --sim-method hole \
        --conv-layers 8 --fp-hidden-dim 32 --epochs 50 --out results/run1
    python train.py --train t.csv --labels-csv labels.csv   # multi-label
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", required=True, help="training pair CSV")
    p.add_argument("--val", default=None, help="validation pair CSV")
    p.add_argument("--preset", default=None, help="named preset config")
    p.add_argument("--method", default=None)
    p.add_argument("--sim-method", dest="sim_method", default=None)
    p.add_argument("--attn", default=None)
    p.add_argument("--conv-layers", dest="conv_layers", type=int, default=None)
    p.add_argument("--fp-hidden-dim", dest="fp_hidden_dim", type=int, default=None)
    p.add_argument("--fp-out-dim", dest="fp_out_dim", type=int, default=None)
    p.add_argument("--net-hidden-dims", dest="net_hidden_dims", default=None,
                   help="comma-separated, e.g. 32,16")
    p.add_argument("--weight-tying", dest="weight_tying", default=None,
                   choices=["true", "false"])
    p.add_argument("--augment", action="store_true", default=None)
    p.add_argument("--balance", action="store_true", default=None)
    p.add_argument("--symmetric", default=None, choices=["or", "and"])
    p.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    p.add_argument("--lr", dest="learning_rate", type=float, default=None)
    p.add_argument("--exp-shift-strategy", dest="lr_shift_strategy",
                   type=int, default=None, choices=[1, 2, 3],
                   help="manual LR-decay epoch schedule (reference "
                        "train_ddi_modify_eval2.py:675-687)")
    p.add_argument("--exp-shift-rate", dest="lr_decay_rate", type=float,
                   default=None, help="LR multiplier at each shift epoch")
    p.add_argument("--clr", default=None,
                   choices=["triangular", "triangular2", "exp_range"],
                   help="cyclical LR instead of exponential shifts "
                        "(reference clr.py)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--patience", dest="early_stop_patience", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-path", dest="compute_path", default=None,
                   choices=["padded", "packed", "coo"])
    p.add_argument("--compute-dtype", dest="compute_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16: packed-path matmuls in bf16 with f32 "
                        "accumulation")
    p.add_argument("--scan-steps", dest="scan_steps", type=int, default=None,
                   help="coo path: train steps per XLA dispatch (lax.scan)")
    p.add_argument("--loss", default=None, choices=["sigmoid_ce", "hinge", "focal"])
    p.add_argument("--focal-gamma", dest="focal_gamma", type=float,
                   default=None)
    p.add_argument("--focal-alpha", dest="focal_alpha", type=float,
                   default=None)
    p.add_argument("--reuse-packs", dest="reuse_packs", action="store_true",
                   default=None,
                   help="reuse epoch-1 packed batches with batch-level "
                        "reshuffle (removes per-epoch host pack cost)")
    p.add_argument("--pack-workers", dest="pack_workers", type=int,
                   default=None)
    p.add_argument("--no-eval-train", dest="eval_train", action="store_false",
                   default=None)
    p.add_argument("--concat-hidden", dest="concat_hidden", action="store_true",
                   default=None)
    p.add_argument("--layer-aggregator", dest="layer_aggregator", default=None)
    p.add_argument("--dropout", dest="fp_dropout_rate", type=float, default=None)
    p.add_argument("--out", dest="out_dir", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--labels-csv", dest="labels_csv", default=None,
                   help="class list CSV -> multi-label training")
    p.add_argument("--label-cols", dest="label_cols", default="label")
    p.add_argument("--smiles-cols", dest="smiles_cols", default="smiles_1,smiles_2")
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. cpu, gpu)")
    p.add_argument("--multi-device", action="store_true", default=None,
                   help="graph-sharded training over all visible devices "
                        "(the reference's --multi-gpu analog; requires "
                        "--compute-path packed)")
    p.add_argument("--debug-checks", action="store_true", default=None,
                   help="validate every COO batch before transfer (turns "
                        "silently-dropped out-of-bounds edges into hard "
                        "errors; debug only)")
    p.add_argument("--step-log", dest="step_log", action="store_true",
                   default=None,
                   help="log each train dispatch's wall time and losses "
                        "(blocks on every dispatch; for measurement)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax NaN checking (fail fast at the op that "
                        "produced a NaN — the numeric-sanitizer mode; "
                        "disables async dispatch, debug only)")
    p.add_argument("--fixed-embeddings", dest="fixed_embeddings", default=None,
                   help="id->vector table (pkl or CSV): train a scoring "
                        "head over frozen per-drug embeddings instead of a "
                        "graph encoder (the mol2vec/SSP baseline route; "
                        "pairs join on drugbank_id_1/2)")
    return p.parse_args(argv)


def _main_fixed(args):
    """--fixed-embeddings route: head-only training over frozen per-drug
    vectors (reference: mol2vec_based_model.py / unsupervised_feature.py),
    producing a run dir predict.py can score (is_fixed_run marker)."""
    from gcnbmp_tpu.train.fixed import (
        load_embedding_table,
        pair_embeddings,
        save_fixed_run,
        train_fixed_embedding_head,
    )

    table = load_embedding_table(args.fixed_embeddings)
    e1, e2, y = pair_embeddings(args.train, table)
    logging.info("train: %d joined pairs over %d embeddings", len(y), len(table))
    val = None
    if args.val:
        val = pair_embeddings(args.val, table)
    sim_method = args.sim_method or "hole"
    class_num = 1
    hidden = tuple(int(x) for x in args.net_hidden_dims.split(",") if x) \
        if args.net_hidden_dims else (32, 16)
    result = train_fixed_embedding_head(
        e1, e2, y, val=val, sim_method=sim_method, class_num=class_num,
        net_hidden_dims=hidden,
        learning_rate=args.learning_rate
        if args.learning_rate is not None else 1e-3,
        epochs=args.epochs if args.epochs is not None else 100,
        batch_size=args.batch_size if args.batch_size is not None else 128,
    )
    out_dir = args.out_dir or "results/fixed_run"
    save_fixed_run(out_dir, result, sim_method=sim_method,
                   class_num=class_num, net_hidden_dims=hidden, table=table)
    final = dict(result["train_metrics"])
    if "val_metrics" in result:
        final.update({f"val/{k}": v for k, v in result["val_metrics"].items()})
    print(json.dumps(final, default=float))
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)
    from gcnbmp_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.fixed_embeddings:
        return _main_fixed(args)
    from gcnbmp_tpu.data.parsers import CSVPairParser, get_class_labels
    from gcnbmp_tpu.train import PRESETS, TrainConfig, Trainer

    cfg = PRESETS[args.preset] if args.preset else TrainConfig()
    overrides = {}
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    if args.weight_tying is not None:
        overrides["weight_tying"] = args.weight_tying == "true"
    if args.net_hidden_dims is not None:
        overrides["net_hidden_dims"] = tuple(
            int(x) for x in args.net_hidden_dims.split(",") if x
        )
    classes = None
    if args.labels_csv:
        classes = get_class_labels(args.labels_csv)
        overrides["class_num"] = len(classes)
    cfg = dataclasses.replace(cfg, **overrides)

    parser = CSVPairParser(
        labels=tuple(args.label_cols.split(",")),
        smiles_cols=tuple(args.smiles_cols.split(",")),
        multi_label_classes=classes,
    )
    train_res = parser.parse(args.train)
    logging.info(
        "train: %d pairs (%d rows failed)",
        len(train_res.dataset), train_res.fail_count,
    )
    val_ds = None
    if args.val:
        val_res = parser.parse(args.val)
        logging.info(
            "val: %d pairs (%d rows failed)", len(val_res.dataset), val_res.fail_count
        )
        val_ds = val_res.dataset

    trainer = Trainer(cfg, train_res.dataset, val_ds)
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    result = trainer.fit()
    final = result["log"][-1] if result["log"] else {}
    print(json.dumps(final))
    return 0


if __name__ == "__main__":
    sys.exit(main())
