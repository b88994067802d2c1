#!/usr/bin/env python
"""Offline evaluation CLI — the equivalent of the reference's eval.py /
eval_coattention.py: load a trained checkpoint, run the predictor over a
test pair CSV, write metrics (eval_result.json) and embedding exports
(<test>_e.csv, <test>_e_y.csv, drug_list_with_representation.csv).

Example:
    python eval.py --test test.csv --run results/run1 --out results/run1/eval
    python eval.py --test test.csv --run results/run1 --checkpoint best \
        --similarity cosine --saliency gradient
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test", required=True, help="test pair CSV")
    p.add_argument("--run", required=True,
                   help="training output dir (contains config.json + checkpoints)")
    p.add_argument("--checkpoint", default="best",
                   help="checkpoint name under the run dir (best/final/snapshot_epoch_N)")
    p.add_argument("--out", default=None, help="output dir (default <run>/eval)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--similarity", default=None,
                   choices=["cosine", "jaccard", "extended-jaccard"],
                   help="also write a drug-drug similarity matrix CSV")
    p.add_argument("--saliency", default=None,
                   choices=["gradient", "integrated", "bayes"],
                   help="also render saliency SVGs for the first pairs")
    p.add_argument("--saliency-count", type=int, default=4)
    p.add_argument("--correlation-matrix", default=None,
                   help="known-DDI drug-drug matrix CSV (columns = cids); "
                        "also compute embedding-similarity vs shared-DDI "
                        "correlation + scatter plot (reference "
                        "result_analysis.py / correlation_all_*.png)")
    p.add_argument("--smiles-cols", default="smiles_1,smiles_2",
                   help="the two SMILES column names (match train.py)")
    p.add_argument("--label-cols", default="label",
                   help="label column name(s) (match train.py)")
    p.add_argument("--labels-csv", dest="labels_csv", default=None,
                   help="class-list CSV for multi-label runs (same file "
                        "given to train.py; enables ||-label parsing)")
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. cpu, gpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)
    from gcnbmp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(level=logging.INFO)

    import numpy as np

    from gcnbmp_tpu.data.parsers import CSVPairParser
    from gcnbmp_tpu.eval.evaluate import evaluate_dataset
    from gcnbmp_tpu.models import set_up_predictor
    from gcnbmp_tpu.train import TrainConfig, Trainer
    from gcnbmp_tpu.train.checkpoints import restore_checkpoint

    with open(os.path.join(args.run, "config.json")) as f:
        cfg = TrainConfig.from_json(f.read())

    classes = None
    if args.labels_csv:
        from gcnbmp_tpu.data.parsers import get_class_labels

        classes = get_class_labels(args.labels_csv)
        if cfg.class_num > 1 and len(classes) != cfg.class_num:
            raise SystemExit(
                f"--labels-csv has {len(classes)} classes but the run was "
                f"trained with class_num={cfg.class_num}"
            )
    elif cfg.class_num > 1:
        raise SystemExit(
            "this run is multi-label (class_num>1); pass the same "
            "--labels-csv used for training so test labels binarize "
            "identically"
        )
    parser = CSVPairParser(
        multi_label_classes=classes,
        smiles_cols=tuple(args.smiles_cols.split(",")),
        labels=tuple(args.label_cols.split(",")),
    )
    res = parser.parse(args.test)
    ds = res.dataset
    logging.info("test: %d pairs (%d failed)", len(ds), res.fail_count)

    # rebuild predictor and restore weights (template only: disable the
    # train-time dataset transforms so the TEST set isn't augmented)
    import dataclasses

    # scan_steps is a TRAINING-only dispatch knob: the eval-time Trainer
    # exists just to build/restore params, and the scan>batches-per-epoch
    # guard must not fire on a smaller test set (round-5 bug)
    trainer = Trainer(dataclasses.replace(cfg, augment=False, balance=False,
                                          scan_steps=1),
                      ds, None)
    template = trainer._init_state()
    state = restore_checkpoint(os.path.join(args.run, args.checkpoint), template)
    out_dir = args.out or os.path.join(args.run, "eval")

    supernode_fn = None
    if cfg.method == "ggnn-gwm":
        from gcnbmp_tpu.models.gwm import default_supernode_fn

        supernode_fn = default_supernode_fn()
    result = evaluate_dataset(
        trainer.predictor, state.params, ds, out_dir=out_dir,
        source_csv=args.test, batch_size=args.batch_size,
        class_num=cfg.class_num, is_successful=res.is_successful,
        supernode_fn=supernode_fn, class_names=classes, train_cfg=cfg,
    )
    print(json.dumps(
        {k: v for k, v in result.metrics.items() if k != "per_class"}
    ))

    if args.similarity:
        from gcnbmp_tpu.eval.similarity import similarity_csv

        # e1 holds ALL left embeddings then e2 all right — order ids the
        # same way (interleaving them mispaired every drug after the first)
        ids = ([p[0] for p in ds.smiles_pairs]
               + [p[1] for p in ds.smiles_pairs])
        emb = np.concatenate([result.e1, result.e2])
        uniq = {}
        for i, s in enumerate(ids):
            uniq.setdefault(s, emb[i])
        similarity_csv(
            np.stack(list(uniq.values())), list(uniq.keys()),
            method=args.similarity,
            out_path=os.path.join(out_dir, f"similarity_{args.similarity}.csv"),
        )
        logging.info("similarity matrix written")

    if args.correlation_matrix:
        import pandas as pd

        from gcnbmp_tpu.eval.analysis import (
            correlation_plot,
            embedding_ddi_correlation,
        )

        mat_df = pd.read_csv(args.correlation_matrix)
        if "Unnamed: 0" in mat_df.columns:  # pandas index column
            mat_df = mat_df.drop(columns=["Unnamed: 0"])
        cids = [str(c) for c in mat_df.columns]
        mat = mat_df.to_numpy()
        # per-drug embedding from the pair exports (cid columns when
        # present, else drugbank ids)
        test_df = pd.read_csv(args.test)
        test_df = test_df[np.asarray(res.is_successful)].reset_index(drop=True)
        emb = {}
        for col, e in (("1", result.e1), ("2", result.e2)):
            idcol = f"cid_{col}" if f"cid_{col}" in test_df.columns else f"drugbank_id_{col}"
            for i, d in enumerate(test_df[idcol].astype(str)):
                emb.setdefault(d, e[i])
        keep = [i for i, d in enumerate(cids) if d in emb]
        if len(keep) < 3:
            raise SystemExit(
                "--correlation-matrix: fewer than 3 matrix drugs appear "
                "in the test CSV ids")
        E = np.stack([emb[cids[i]] for i in keep])
        sub = mat[np.ix_(keep, keep)]
        corr, s, c = embedding_ddi_correlation(E, sub)
        png = os.path.join(out_dir, f"correlation_all_{corr:.4f}.png")
        correlation_plot(s, c, corr, png)
        with open(os.path.join(out_dir, "correlation.json"), "w") as f:
            json.dump({"pearson_correlation": corr, "n_drugs": len(keep)}, f,
                      indent=2)
        logging.info("correlation %.4f over %d drugs -> %s",
                     corr, len(keep), png)

    if args.saliency:
        from gcnbmp_tpu.chem import mol_from_smiles
        from gcnbmp_tpu.data.dataset import make_batch
        from gcnbmp_tpu.eval.saliency import atom_saliency, render_molecule_svg

        k = min(args.saliency_count, len(ds))
        batch = make_batch(ds, list(range(k)))
        try:
            sal = atom_saliency(
                trainer.predictor, state.params,
                batch.atoms1, batch.adj1, batch.atoms2, batch.adj2,
                batch.mask1, batch.mask2, method=args.saliency,
            )
        except NotImplementedError as e:
            logging.warning("saliency skipped: %s", e)
            return 0
        os.makedirs(os.path.join(out_dir, "saliency"), exist_ok=True)
        for i in range(k):
            for side, key in (("mol1", 0), ("mol2", 1)):
                smi = ds.smiles_pairs[i][key]
                mol = mol_from_smiles(smi)
                svg = render_molecule_svg(mol, sal[side][i])
                with open(
                    os.path.join(out_dir, "saliency", f"pair{i}_{side}.svg"), "w"
                ) as f:
                    f.write(svg)
        logging.info("saliency SVGs written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
