"""Typed training configuration.

Replaces the reference's ~45 argparse flags duplicated per entry script
(reference: train_ddi_modify_eval2.py:329-461) with one dataclass; the
string-boolean quirks (``--weight-tying=False`` compared as a string at
:513-514) are gone by construction.  ``PRESETS`` mirror the 5 BASELINE
configs (BASELINE.json "configs").
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

COMPUTE_PATHS = ("padded", "packed", "coo")


@dataclass
class TrainConfig:
    # model
    method: str = "ggnn"                      # encoder family
    sim_method: str = "hole"                  # scoring head
    attn: Optional[str] = None                # co-attention variant
    fp_hidden_dim: int = 16
    fp_out_dim: int = 16
    conv_layers: int = 4
    concat_hidden: bool = False
    layer_aggregator: Optional[str] = None
    fp_dropout_rate: float = 0.0
    fp_batch_normalization: bool = False
    weight_tying: bool = True
    net_hidden_dims: Tuple[int, ...] = ()
    class_num: int = 1                        # 1 = binary; >1 = multi-label
    siamese: bool = True
    symmetric: Optional[str] = None           # 'or' | 'and'
    mask_padding: bool = True                 # False = reference parity quirk

    # data
    augment: bool = False                     # swap-pair augmentation
    balance: bool = False                     # pos/neg rebalance
    max_pad: Optional[int] = None             # fixed pad size (else buckets)
    # packed-supergraph path: train steps run over 128-atom packed
    # tiles; 'coo' ships the adjacency as a COO edge list and
    # materializes it on device (native C++ packer when built).
    # 'padded' = reference-style batching.
    compute_path: str = "padded"              # padded | packed | coo
    prefetch: int = 2                         # batches staged ahead (0 = off)
    prefetch_workers: int = 4                 # concurrent device transfers
    pack_workers: int = 4                     # host pack lookahead threads
    # reuse epoch-1's packed batches for the whole run, reshuffled at
    # BATCH granularity each epoch (partition shuffling): removes the
    # per-epoch host pack cost from the steady-state pipeline entirely
    # (VERDICT r3 #2 — the bf16 scan step had become pack-bound).
    # Trade-off: pairs stay grouped into the same batches after epoch 1;
    # quality validated at reference scale (docs/QUALITY.md r4 row).
    reuse_packs: bool = False
    scan_steps: int = 0                       # coo path: run this many train
    # steps per XLA dispatch via lax.scan over stacked batches (0/1 = off);
    # amortizes the per-dispatch host overhead

    # optimization (flagship: DDI.md:6 — lr 1e-3, x0.5 at [10..60], b=32)
    loss: str = "sigmoid_ce"                  # sigmoid_ce | hinge | focal
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    batch_size: int = 32
    learning_rate: float = 1e-3
    lr_shift_strategy: int = 1                # 1|2|3 (reference :675-687)
    lr_decay_rate: float = 0.5
    weight_decay: float = 0.0                 # L2 (Chainer WeightDecay hook)
    lasso: float = 0.0                        # L1 (Chainer Lasso hook)
    grad_clip: float = 0.0                    # 0 = off (GradientClipping)
    clr: Optional[str] = None                 # cyclical LR: triangular|triangular2|exp_range
    clr_max_lr: float = 6e-3
    clr_step_size: int = 2000                 # iterations per half-cycle
    clr_gamma: float = 0.99994
    epochs: int = 500
    early_stop_patience: int = 10             # epochs (reference :595)
    seed: int = 2018                          # GLOBAL_SEED (setting.py:13)

    # precision
    compute_dtype: str = "float32"            # 'bfloat16' for the fast path

    # io / observability
    out_dir: str = "results"
    snapshot_interval: int = 2                # epochs (reference :701)
    resume: Optional[str] = None
    plot_reports: bool = True                 # loss.png / accuracy.png
    eval_train: bool = True                   # per-epoch train-set metrics
                                              # (reference behavior; turn off
                                              # to halve per-epoch eval cost)
    # jax.profiler trace of this one epoch, written to <out_dir>/profile
    # (tracing slows the host; keep timings from untraced epochs)
    profile_epoch: Optional[int] = None
    multi_device: bool = False                # graph-sharded training over
    #   all visible devices (parallel/edgeshard.py; the reference's
    #   --multi-gpu ParallelUpdater analog). compute_path='packed',
    #   binary sigmoid-CE only.
    debug_checks: bool = False                # debug mode (SURVEY §5.2):
    #   wraps the train step in jax checkify (float+index error sets —
    #   NaN/inf anywhere in the step and OOB gathers become hard errors)
    #   and validates every COO batch host-side (PackedCOOBatch.validate:
    #   turns silently-dropped OOB edges into hard errors).  Debug only —
    #   adds a checking pass to the program and host work per batch.
    check_numerics: bool = False              # fail fast on nan/inf loss (checked once per epoch)
    step_log: bool = False                    # log every train dispatch's
    #   wall time (call to outputs ready, "dispatch_s") and losses
    #   ("step_losses") in the epoch entry; blocks on each dispatch, so
    #   for measurement only

    def __post_init__(self):
        if self.compute_path not in COMPUTE_PATHS:
            raise ValueError(
                f"compute_path={self.compute_path!r}; choose one of "
                f"{COMPUTE_PATHS}")

    def lr_shift_epochs(self) -> Tuple[int, ...]:
        """The three manual ExponentialShift schedules
        (reference: train_ddi_modify_eval2.py:675-687)."""
        return {
            1: (10, 20, 30, 40, 50, 60),
            2: (10, 20, 30, 40, 50, 60, 70, 80, 90, 100),
            3: (25, 50, 75, 100),
        }[self.lr_shift_strategy]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        if d.get("net_hidden_dims") is not None:
            d["net_hidden_dims"] = tuple(d["net_hidden_dims"])
        return TrainConfig(**d)


# The five workload presets from BASELINE.json "configs".
PRESETS = {
    # 1. flagship binary DDI: GGNN + HolE (DDI.md:6 hyperparameters)
    "ggnn_hole_binary": TrainConfig(
        method="ggnn", sim_method="hole", conv_layers=8, fp_hidden_dim=32,
        fp_out_dim=32, weight_tying=False, learning_rate=1e-3,
        lr_shift_strategy=1, batch_size=32, augment=True,
    ),
    # 2. co-attention: GGNN + attention readout + co-attention
    "ggnn_coattention": TrainConfig(
        method="ggnn", sim_method="ntn", attn="para", conv_layers=8,
        fp_hidden_dim=32, fp_out_dim=32, weight_tying=False,
        early_stop_patience=50,
    ),
    # 3. RelGCN relational message passing
    "relgcn_binary": TrainConfig(
        method="relgcn", sim_method="hole", fp_hidden_dim=32, fp_out_dim=64,
    ),
    # 4. GIN / MPNN variants
    "gin_binary": TrainConfig(
        method="gin", sim_method="hole", conv_layers=8, fp_hidden_dim=32,
        fp_out_dim=32,
    ),
    # 5. multi-label x37 with jumping knowledge
    "ggnn_multilabel_x37": TrainConfig(
        method="ggnn", sim_method="hole", class_num=37, conv_layers=8,
        fp_hidden_dim=32, fp_out_dim=32, layer_aggregator="concat",
    ),
    # 6. the x86 long-tail regime, with the measured-best loss (round
    # 4: focal alpha=0.75 lifts tail F1 0.605 -> 0.744 and recall
    # 0.516 -> 0.731 over plain CE at equal ranking quality —
    # docs/QUALITY.md)
    "ggnn_multilabel_x86": TrainConfig(
        method="ggnn", sim_method="hole", class_num=86, conv_layers=8,
        fp_hidden_dim=32, fp_out_dim=32, weight_tying=False,
        compute_path="coo", compute_dtype="bfloat16", scan_steps=10,
        batch_size=512, learning_rate=2e-3, lr_shift_strategy=3,
        loss="focal", focal_alpha=0.75, epochs=120,
        early_stop_patience=25,
    ),
    # 7. the sustained-throughput production recipe: bf16 + scan +
    # reuse-packs, validated for quality parity (docs/QUALITY.md)
    "ggnn_hole_production": TrainConfig(
        method="ggnn", sim_method="hole", conv_layers=8, fp_hidden_dim=32,
        fp_out_dim=32, weight_tying=False, compute_path="coo",
        compute_dtype="bfloat16", scan_steps=10, reuse_packs=True,
        batch_size=2048, learning_rate=2e-3, augment=True,
    ),
}
