#!/bin/bash
# Reference-scale quality battery: generates dataset/synth546, trains every
# headline reference configuration (BASELINE.md) on it, and evaluates each
# on the held-out stratified test set. See docs/QUALITY.md for results.
# Runs on the default JAX platform (a GPU when one is present).
#
# NOTE (round 3): the GWM-dense and the 8k-subset MPNN/NFP/JKNet blocks
# below are SUPERSEDED by full-scale production-path runs in
# scripts/quality_battery_r3.sh (plus scripts/coattn_battery_r3.sh for
# the remaining 9 co-attention variants); they are kept for
# padded<->packed cross-checks only.
set -euo pipefail
cd "$(dirname "$0")/.."

python examples/make_synth_drugbank.py --out dataset/synth546 --multi-label
python data_generator.py --drug-list dataset/synth546/drug_list.csv \
  --matrix dataset/synth546/drug_drug_matrix.csv \
  --split inter --out dataset/synth546/inter --validate
python - <<'EOF'
import pandas as pd
df = pd.read_csv("dataset/synth546/inter/ddi_inter_train.csv")
pos, neg = df[df.label==1], df[df.label==0]
sub = pd.concat([pos.sample(17500, random_state=1), neg.sample(17500, random_state=1)])
sub.sample(frac=1.0, random_state=2).to_csv(
    "dataset/synth546/inter/isc35000_train.csv", index=False)
EOF

run () {  # run OUTDIR [train.py extra args...]
  local out=$1; shift
  python train.py --train dataset/synth546/inter/isc35000_train.csv \
    --val dataset/synth546/inter/ddi_inter_valid.csv \
    --method ggnn --conv-layers 8 --fp-hidden-dim 32 --fp-out-dim 32 \
    --weight-tying false --compute-path coo --batch-size 2048 --lr 2e-3 \
    --epochs 80 --patience 10 --augment --no-eval-train --seed 0 \
    --out "results/$out" "$@"
  python eval.py --test dataset/synth546/inter/ddi_inter_test.csv \
    --run "results/$out" --checkpoint best --out "results/$out/eval"
}

run ref_scale       --sim-method hole                 # flagship (DDI.md:6)
run ref_scale_scan  --sim-method hole --scan-steps 10 # headline scan mode
# round-2 headline: scan + bf16 matmuls (f32 accumulation)
run ref_scale_bf16scan --sim-method hole --scan-steps 10 --compute-dtype bfloat16
run ref_scale_alter --sim-method hole --attn alter    # RECORD.txt:201
run ref_scale_para  --sim-method ntn  --attn para     # RECORD.txt:209
run ref_scale_nie   --sim-method ntn  --attn nie      # RECORD.txt:250
run ref_scale_vqa   --sim-method ntn  --attn vqa      # RECORD.txt:264
run ref_scale_circ  --sim-method ntn  --attn circ
run ref_scale_bimpm --sim-method ntn  --attn bimpm

# alternative encoders at reference scale on the packed COO fast path
# (BASELINE.json configs: RelGCN relational message passing; GIN variant)
run ref_scale_relgcn --method relgcn --sim-method hole
run ref_scale_gin    --method gin    --sim-method hole

# MPNN (EdgeNet messages + Set2Set readout) at FULL isc35000 scale on the
# packed COO fast path (PackedMPNN: segment-softmax Set2Set); the
# reference-default 4 tied layers
run ref_scale_mpnn_full --method mpnn --sim-method hole --conv-layers 4 \
  --weight-tying true

# GGNN-GWM (supernode warp) at FULL isc35000 scale on the dense packed
# fast path (PackedGGNN_GWM: per-molecule supernode table).  NOTE:
# per-epoch val metrics ride the padded evaluator (GWM has no COO
# layout), so val uses a 4k subsample; the final test eval is the full
# stratified set.  Needs inter_valid_4k.csv from the subset block below.
python - <<'EOF'
import pandas as pd
for split in ("valid", "test"):
    d = pd.read_csv(f"dataset/synth546/inter/ddi_inter_{split}.csv")
    d.sample(4000, random_state=3).to_csv(
        f"dataset/synth546/inter/inter_{split}_4k.csv", index=False)
EOF
python train.py --train dataset/synth546/inter/isc35000_train.csv \
  --val dataset/synth546/inter/inter_valid_4k.csv \
  --method ggnn-gwm --sim-method hole --conv-layers 4 --fp-hidden-dim 32 \
  --fp-out-dim 32 --compute-path packed --batch-size 2048 --lr 2e-3 \
  --epochs 30 --patience 10 --augment --no-eval-train --seed 0 \
  --out results/ref_scale_gwm_full
python eval.py --test dataset/synth546/inter/ddi_inter_test.csv \
  --run results/ref_scale_gwm_full --checkpoint best \
  --out results/ref_scale_gwm_full/eval

# MPNN padded-path subset row (kept for padded<->packed cross-checks)
python - <<'EOF'
import pandas as pd
df = pd.read_csv("dataset/synth546/inter/isc35000_train.csv")
df.sample(8000, random_state=3).to_csv(
    "dataset/synth546/inter/isc8000_train.csv", index=False)
for split in ("valid", "test"):
    d = pd.read_csv(f"dataset/synth546/inter/ddi_inter_{split}.csv")
    d.sample(4000, random_state=3).to_csv(
        f"dataset/synth546/inter/inter_{split}_4k.csv", index=False)
EOF
python train.py --train dataset/synth546/inter/isc8000_train.csv \
  --val dataset/synth546/inter/inter_valid_4k.csv \
  --method mpnn --sim-method hole --conv-layers 4 --fp-hidden-dim 32 \
  --fp-out-dim 32 --batch-size 256 --lr 2e-3 --epochs 40 --patience 10 \
  --no-eval-train --seed 0 --out results/ref_scale_mpnn
python eval.py --test dataset/synth546/inter/inter_test_4k.csv \
  --run results/ref_scale_mpnn --checkpoint best \
  --out results/ref_scale_mpnn/eval --batch-size 256

# NFP (neural fingerprint) — same subset protocol
python train.py --train dataset/synth546/inter/isc8000_train.csv \
  --val dataset/synth546/inter/inter_valid_4k.csv \
  --method nfp --sim-method hole --conv-layers 4 --fp-hidden-dim 32 \
  --fp-out-dim 32 --batch-size 256 --lr 2e-3 --epochs 40 --patience 10 \
  --no-eval-train --seed 0 --out results/ref_scale_nfp
python eval.py --test dataset/synth546/inter/inter_test_4k.csv \
  --run results/ref_scale_nfp --checkpoint best \
  --out results/ref_scale_nfp/eval --batch-size 256

# harder generalization splits (the reference's similarity-split study)
python data_generator.py --drug-list dataset/synth546/drug_list.csv \
  --matrix dataset/synth546/drug_drug_matrix.csv --split drug \
  --out dataset/synth546/drug
python data_generator.py --drug-list dataset/synth546/drug_list.csv \
  --matrix dataset/synth546/drug_drug_matrix.csv --split scaffold \
  --out dataset/synth546/scaffold
run2 () {  # run2 OUTDIR SPLITDIR PREFIX
  local out=$1 dir=$2 pre=$3
  python train.py --train "$dir/ddi_${pre}_train.csv" --val "$dir/ddi_${pre}_valid.csv" \
    --method ggnn --conv-layers 8 --fp-hidden-dim 32 --fp-out-dim 32 \
    --weight-tying false --compute-path coo --batch-size 2048 --lr 2e-3 \
    --epochs 80 --patience 10 --augment --no-eval-train --seed 0 \
    --sim-method hole --out "results/$out"
  python eval.py --test "$dir/ddi_${pre}_test.csv" \
    --run "results/$out" --checkpoint best --out "results/$out/eval"
}
run2 ref_scale_drugsplit dataset/synth546/drug drug
run2 ref_scale_scafsplit dataset/synth546/scaffold scaffold

# similarity + saliency exports off the flagship run
python eval.py --test dataset/synth546/inter/ddi_inter_test.csv \
  --run results/ref_scale --checkpoint best --out results/ref_scale/eval \
  --similarity cosine --saliency gradient

# multi-label (x86-style): kaist split + multi-hot training
python data_generator.py --split kaist \
  --kaist-csv dataset/synth546/pairs_multilabel.csv --out dataset/synth546/kaist
python train.py --train dataset/synth546/kaist/ddi_train_multi.csv \
  --val dataset/synth546/kaist/ddi_valid_multi.csv \
  --labels-csv dataset/synth546/labels.csv \
  --method ggnn --sim-method hole --conv-layers 8 --fp-hidden-dim 32 \
  --fp-out-dim 32 --weight-tying false --compute-path coo --batch-size 2048 \
  --lr 2e-3 --epochs 80 --patience 10 --no-eval-train --seed 0 \
  --out results/ref_scale_multi
python eval.py --test dataset/synth546/kaist/ddi_test_multi.csv \
  --run results/ref_scale_multi --checkpoint best \
  --labels-csv dataset/synth546/labels.csv --out results/ref_scale_multi/eval

# multi-label with JKNet/GRU jumping-knowledge fusion (BASELINE.json
# config 5; padded path — layer aggregators are not on the packed path)
python - <<'EOF'
import pandas as pd
for split, n in (("train", 8000), ("valid", 4000), ("test", 4000)):
    d = pd.read_csv(f"dataset/synth546/kaist/ddi_{split}_multi.csv")
    d.sample(min(n, len(d)), random_state=3).to_csv(
        f"dataset/synth546/kaist/ddi_{split}_multi_sub.csv", index=False)
EOF
python train.py --train dataset/synth546/kaist/ddi_train_multi_sub.csv \
  --val dataset/synth546/kaist/ddi_valid_multi_sub.csv \
  --labels-csv dataset/synth546/labels.csv \
  --method ggnn --sim-method hole --conv-layers 8 --fp-hidden-dim 32 \
  --fp-out-dim 32 --weight-tying false --layer-aggregator gru \
  --batch-size 256 --lr 2e-3 --epochs 40 --patience 10 \
  --no-eval-train --seed 0 --out results/ref_scale_jkgru_multi
python eval.py --test dataset/synth546/kaist/ddi_test_multi_sub.csv \
  --run results/ref_scale_jkgru_multi --checkpoint best \
  --labels-csv dataset/synth546/labels.csv \
  --out results/ref_scale_jkgru_multi/eval --batch-size 256

# KAIST-scale multi-label (x37-style): 1704 drugs x 37 interaction types
# (reference setting.py NUM_DRUGS_KAIST / train_ggnn_hole_multi_class_x37.py)
python examples/make_synth_drugbank.py --out dataset/synth1704 --kaist
python data_generator.py --split kaist \
  --kaist-csv dataset/synth1704/pairs_multilabel.csv --out dataset/synth1704/kaist
python train.py --train dataset/synth1704/kaist/ddi_train_multi.csv \
  --val dataset/synth1704/kaist/ddi_valid_multi.csv \
  --labels-csv dataset/synth1704/labels.csv \
  --method ggnn --sim-method hole --conv-layers 8 --fp-hidden-dim 32 \
  --fp-out-dim 32 --weight-tying false --compute-path coo --batch-size 2048 \
  --lr 2e-3 --epochs 250 --patience 25 --exp-shift-strategy 3 \
  --no-eval-train --seed 0 --out results/kaist1704_x37
python eval.py --test dataset/synth1704/kaist/ddi_test_multi.csv \
  --run results/kaist1704_x37 --checkpoint best \
  --labels-csv dataset/synth1704/labels.csv --out results/kaist1704_x37/eval

# KAIST-scale x37 on the round-2 fast mode (bf16 matmuls + scan)
python train.py --train dataset/synth1704/kaist/ddi_train_multi.csv \
  --val dataset/synth1704/kaist/ddi_valid_multi.csv \
  --labels-csv dataset/synth1704/labels.csv \
  --method ggnn --sim-method hole --conv-layers 8 --fp-hidden-dim 32 \
  --fp-out-dim 32 --weight-tying false --compute-path coo --batch-size 2048 \
  --lr 2e-3 --epochs 120 --patience 25 --exp-shift-strategy 3 \
  --compute-dtype bfloat16 --scan-steps 10 \
  --no-eval-train --seed 0 --out results/kaist1704_x37_bf16
python eval.py --test dataset/synth1704/kaist/ddi_test_multi.csv \
  --run results/kaist1704_x37_bf16 --checkpoint best \
  --labels-csv dataset/synth1704/labels.csv \
  --out results/kaist1704_x37_bf16/eval

# KAIST-scale x37 with NTN + nie fine-grained co-attention
# (reference RECORD.txt:250 head/attn on the multi-label task)
python train.py --train dataset/synth1704/kaist/ddi_train_multi.csv \
  --val dataset/synth1704/kaist/ddi_valid_multi.csv \
  --labels-csv dataset/synth1704/labels.csv \
  --method ggnn --sim-method ntn --attn nie --conv-layers 8 \
  --fp-hidden-dim 32 --fp-out-dim 32 --weight-tying false \
  --compute-path coo --batch-size 2048 --lr 2e-3 --epochs 250 \
  --patience 25 --exp-shift-strategy 3 --no-eval-train --seed 0 \
  --out results/kaist1704_x37_nie
python eval.py --test dataset/synth1704/kaist/ddi_test_multi.csv \
  --run results/kaist1704_x37_nie --checkpoint best \
  --labels-csv dataset/synth1704/labels.csv \
  --out results/kaist1704_x37_nie/eval --batch-size 512
