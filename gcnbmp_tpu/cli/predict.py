#!/usr/bin/env python
"""Inference CLI: score drug-pair CSVs with a trained checkpoint.

The serving-side entry point (the reference only exposes prediction
through its eval scripts): reads a pair CSV (label column optional),
writes predictions.csv with sigmoid probabilities (+ per-class columns
for multi-label models).

    python predict.py --input pairs.csv --run results/run1 --out preds.csv
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="pair CSV to score")
    p.add_argument("--run", required=True, help="training output dir")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--out", default=None, help="output CSV (default stdout)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--smiles-cols", default="smiles_1,smiles_2",
                   help="the two SMILES column names (match train.py)")
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. cpu, gpu)")
    args = p.parse_args(argv)
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)
    from gcnbmp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import pandas as pd

    from gcnbmp_tpu.train.fixed import is_fixed_run

    if is_fixed_run(args.run):
        # fixed-embedding run (mol2vec/SSP baseline; the reference's
        # mol2vec_predict.py analog): score pairs straight from the
        # run's embedding table — no SMILES parsing at all
        from gcnbmp_tpu.train.fixed import score_fixed_pairs

        df = pd.read_csv(args.input)
        id_cols = [c.replace("smiles", "drugbank_id")
                   for c in args.smiles_cols.split(",")]
        for c in id_cols:
            if c not in df.columns:
                raise SystemExit(
                    f"fixed-embedding run needs id column {c!r} in --input")
        probs, present = score_fixed_pairs(
            args.run, df[id_cols[0]], df[id_cols[1]],
            batch_size=args.batch_size)
        logging.info("scoring %d pairs (%d ids missing from table)",
                     int(present.sum()), int((~present).sum()))
        out = df[present].reset_index(drop=True).copy()
        if probs.ndim == 1:
            out["prob"] = probs
        else:
            for c in range(probs.shape[1]):
                out[f"prob_class{c}"] = probs[:, c]
        if args.out:
            out.to_csv(args.out, index=False)
            logging.info("wrote %s", args.out)
        else:
            out.to_csv(sys.stdout, index=False)
        return 0

    from gcnbmp_tpu.data.parsers import CSVPairParser
    from gcnbmp_tpu.eval.evaluate import PairEvaluator
    from gcnbmp_tpu.train import TrainConfig, Trainer
    from gcnbmp_tpu.train.checkpoints import restore_checkpoint

    with open(os.path.join(args.run, "config.json")) as f:
        cfg = TrainConfig.from_json(f.read())

    df = pd.read_csv(args.input)
    df = df.copy()
    # scores are what matters: force a uniform valid label so rows with
    # missing/negative labels aren't dropped by the evaluator (which
    # would misalign probs with the output frame)
    df["label"] = 0
    res = CSVPairParser(
        smiles_cols=tuple(args.smiles_cols.split(",")),
    ).parse(df)
    logging.info("scoring %d pairs (%d unparseable)",
                 len(res.dataset), res.fail_count)

    import dataclasses

    trainer = Trainer(
        # scan_steps is a training-only knob; prediction-time Trainer
        # construction must not trip its batches-per-epoch guard
        dataclasses.replace(cfg, augment=False, balance=False, scan_steps=1),
        res.dataset, None,
    )
    state = restore_checkpoint(
        os.path.join(args.run, args.checkpoint), trainer._init_state()
    )
    supernode_fn = None
    if cfg.method == "ggnn-gwm":
        from gcnbmp_tpu.models.gwm import default_supernode_fn

        supernode_fn = default_supernode_fn()
    from gcnbmp_tpu.eval.evaluate import PackedPairEvaluator, _packed_eval_eligible

    if _packed_eval_eligible(cfg, supernode_fn):
        evaluator = PackedPairEvaluator(
            cfg, state.params, batch_size=args.batch_size,
            class_num=cfg.class_num,
        )
    else:
        evaluator = PairEvaluator(
            trainer.predictor, state.params, batch_size=args.batch_size,
            class_num=cfg.class_num, supernode_fn=supernode_fn,
        )
    result = evaluator.evaluate(res.dataset)
    probs = 1.0 / (1.0 + np.exp(-result.logits))

    out = df[np.asarray(res.is_successful)].reset_index(drop=True).copy()
    if probs.ndim == 1 or probs.shape[-1] == 1:
        out["prob"] = np.ravel(probs)
    else:
        for c in range(probs.shape[1]):
            out[f"prob_class{c}"] = probs[:, c]
    if args.out:
        out.to_csv(args.out, index=False)
        logging.info("wrote %s", args.out)
    else:
        out.to_csv(sys.stdout, index=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
