"""Training loop: jit-compiled steps, Adam + hooks, early stopping,
epoch-level metric evaluators, snapshots.

Re-expresses the reference's Chainer Trainer stack
(train_ddi_modify_eval2.py:471-723: SerialIterator -> Classifier ->
Adam+hooks -> StandardUpdater(concat_mols) -> EarlyStopping + evaluator
extensions + ExponentialShift + snapshots) as a functional JAX loop:

- one jitted train step per padded-shape bucket (XLA caches by shape);
- loss = sigmoid cross entropy (binary or multi-hot multi-label);
- optimizer = optax adam with GradientClipping / WeightDecay / Lasso
  equivalents (reference :575-580);
- epoch-end: full-dataset logits on train & val -> host-side numpy
  metrics (the BatchEvaluator design);
- early stopping on val loss with patience (reference :595);
- checkpoints every ``snapshot_interval`` epochs + resume.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from gcnbmp_tpu.data.dataset import PairDataset, batch_iterator, make_batch
from gcnbmp_tpu.train.config import TrainConfig
from gcnbmp_tpu.train.metrics import compute_metrics
from gcnbmp_tpu.train.schedules import (
    cyclical_schedule,
    exponential_shift_schedule,
)

logger = logging.getLogger(__name__)


def sigmoid_ce_elements(logits, labels):
    """Per-element sigmoid CE + validity mask (labels < 0 ignored) —
    the elementwise single source of truth for the single-device mean
    below and the edgeshard global-mean psums."""
    per = optax.sigmoid_binary_cross_entropy(logits, labels)
    valid = (labels >= 0).astype(per.dtype)
    return per, valid


def sigmoid_cross_entropy(
    logits: jnp.ndarray, labels: jnp.ndarray
) -> jnp.ndarray:
    """Chainer F.sigmoid_cross_entropy (normalize=True): mean over all
    elements of the element-wise sigmoid CE; labels < 0 are ignored."""
    logits = jnp.reshape(logits, labels.shape)
    per_elem, valid = sigmoid_ce_elements(logits, labels)
    denom = jnp.maximum(jnp.sum(valid), 1.0)
    return jnp.sum(per_elem * valid) / denom


def hinge_elements(logits, labels):
    """Elementwise binary hinge over +-1 targets + validity mask."""
    sign = 2.0 * labels - 1.0
    valid = (labels >= 0).astype(logits.dtype)
    per = jnp.maximum(0.0, 1.0 - sign * logits)
    return per, valid


def hinge_loss(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Binary hinge loss over +-1 targets (the Classifier's optional
    hinge lossfun, reference train_ddi_modify_eval2.py:566)."""
    logits = jnp.reshape(logits, labels.shape)
    per, valid = hinge_elements(logits, labels)
    return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)


def focal_elements(gamma: float = 2.0, alpha: float = 0.25):
    """Elementwise sigmoid focal loss (Lin et al. 2017) + validity
    mask: the single source of truth for both the single-device
    reduction below and the edgeshard global-mean psums
    (parallel/edgeshard.py).  The reference ships a SigmoidFocalLoss
    FunctionNode with an undefined variable in its backward
    (functions.py:101) that cannot run; this is the fixed
    implementation of the intended feature.

    Ignored labels (< 0, the pair-padding fill) are CLAMPED before the
    math: with raw -1 labels, (1 - p_t)**gamma is NaN for non-integer
    gamma (negative base), and NaN*0 masking does not sanitize it —
    the whole loss and every gradient would NaN (round-4 review
    finding)."""

    def fn(logits, labels):
        valid = (labels >= 0).astype(logits.dtype)
        y = jnp.clip(labels, 0.0, 1.0)
        p = jax.nn.sigmoid(logits)
        ce = optax.sigmoid_binary_cross_entropy(logits, y)
        p_t = p * y + (1.0 - p) * (1.0 - y)
        alpha_t = alpha * y + (1.0 - alpha) * (1.0 - y)
        per = alpha_t * (1.0 - p_t) ** gamma * ce
        return per, valid

    return fn


def sigmoid_focal_loss(
    logits: jnp.ndarray, labels: jnp.ndarray,
    gamma: float = 2.0, alpha: float = 0.25,
) -> jnp.ndarray:
    """Mean-reduced focal loss (see focal_elements)."""
    logits = jnp.reshape(logits, labels.shape)
    per, valid = focal_elements(gamma, alpha)(logits, labels)
    return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)


def make_loss(name: str, **kwargs):
    if name in ("sigmoid_ce", "sigmoid_cross_entropy"):
        return sigmoid_cross_entropy
    if name == "hinge":
        return hinge_loss
    if name == "focal":
        import functools

        return functools.partial(sigmoid_focal_loss, **kwargs)
    raise ValueError(f"unknown loss {name!r}")


def l1_penalty(weight: float) -> optax.GradientTransformation:
    """Chainer Lasso hook: grad += l1 * sign(param)."""

    def init_fn(params):
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        updates = jax.tree.map(
            lambda g, p: g + weight * jnp.sign(p), updates, params
        )
        return updates, state

    return optax.GradientTransformation(init_fn, update_fn)


def build_optimizer(
    config: TrainConfig, steps_per_epoch: int
) -> Tuple[optax.GradientTransformation, Callable]:
    if config.clr:
        schedule = cyclical_schedule(
            config.learning_rate,
            config.clr_max_lr,
            config.clr_step_size,
            mode=config.clr,
            gamma=config.clr_gamma,
        )
    else:
        schedule = exponential_shift_schedule(
            config.learning_rate,
            config.lr_shift_epochs(),
            steps_per_epoch,
            rate=config.lr_decay_rate,
        )
    chain = []
    if config.grad_clip > 0:
        chain.append(optax.clip_by_global_norm(config.grad_clip))
    if config.weight_decay > 0:
        chain.append(optax.add_decayed_weights(config.weight_decay))
    if config.lasso > 0:
        chain.append(l1_penalty(config.lasso))
    chain.append(optax.adam(schedule))
    return optax.chain(*chain), schedule


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    epoch: int
    best_val_loss: float
    epochs_since_best: int


def _jit_step(fn, debug_checks: bool = False, **jit_kwargs):
    """jit a train-step function; with ``debug_checks`` the step is wrapped
    in ``checkify`` (float + index error sets: NaN/inf anywhere in the
    step and out-of-bounds gathers/scatters become hard Python errors
    instead of silent clamps) — the SURVEY §5.2 debug mode.  Adds a pass
    over the whole program; debug only."""
    if not debug_checks:
        return jax.jit(fn, **jit_kwargs)
    from jax.experimental import checkify

    # debug mode favors safety over the copy saved by donation: donated
    # inputs are deleted after the call, which breaks callers that
    # re-invoke the step with the same tree while diagnosing an error
    jit_kwargs.pop("donate_argnums", None)
    checked = checkify.checkify(
        fn, errors=checkify.float_checks | checkify.index_checks
    )
    jfn = jax.jit(checked, **jit_kwargs)

    def wrapper(*args):
        err, out = jfn(*args)
        checkify.check_error(err)
        return out

    return wrapper


def make_train_step(predictor, optimizer, class_num: int = 1,
                    loss: Callable = sigmoid_cross_entropy,
                    uses_supernodes: bool = False,
                    debug_checks: bool = False):
    """Returns jitted (params, opt_state, batch_arrays[, supers], rng) ->
    updated.  ``uses_supernodes`` threads the GWM supernode vectors.

    params/opt_state buffers are DONATED (in-place update, no copy):
    the input trees are consumed by each call — always rebind from the
    returned tuple; reusing a passed-in tree afterwards raises a
    deleted-buffer error.  (``debug_checks=True`` disables donation.)"""

    def loss_fn(params, atoms1, adj1, atoms2, adj2, mask1, mask2,
                supers, labels, rng):
        kwargs = {}
        if uses_supernodes:
            kwargs = {"super1": supers[0], "super2": supers[1]}
        logits = predictor.apply(
            {"params": params},
            atoms1, adj1, atoms2, adj2, mask1, mask2,
            deterministic=False,
            rngs={"dropout": rng},
            **kwargs,
        )
        if class_num == 1:
            logits = jnp.reshape(logits, labels.shape)
        return loss(logits, labels), logits

    def step_fn(params, opt_state, atoms1, adj1, atoms2, adj2, mask1, mask2,
                supers, labels, rng):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, atoms1, adj1, atoms2, adj2, mask1, mask2, supers,
            labels, rng,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, logits

    return _jit_step(step_fn, debug_checks, donate_argnums=(0, 1))


def make_packed_train_step(packed_predictor, optimizer,
                           class_num: int = 1,
                           loss: Callable = sigmoid_cross_entropy,
                           debug_checks: bool = False):
    """Train step over the packed supergraph layout (data/packing.py).
    params/opt_state are donated — rebind from the returned tuple (see
    make_train_step)."""

    def loss_fn(params, atom_ids, adj, mol_id, node_mask, left, right, labels):
        logits = packed_predictor.apply(
            {"params": params}, atom_ids, adj, mol_id, node_mask, left, right
        )
        if class_num == 1:
            logits = jnp.reshape(logits, labels.shape)
        return loss(logits, labels), logits

    def step_fn(params, opt_state, atom_ids, adj, mol_id, node_mask,
                left, right, labels):
        (l, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, atom_ids, adj, mol_id, node_mask, left, right, labels
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, l, logits

    return _jit_step(step_fn, debug_checks, donate_argnums=(0, 1))


def packed_batch_iterator(ds: PairDataset, batch_size: int, num_tiles: int,
                          rng: np.random.Generator, supernode_fn=None):
    """Shuffled packed batches with a fixed tile count (closed jit
    shapes).  Drops the tail batch (training only)."""
    from gcnbmp_tpu.data.packing import pack_pair_dataset_batch

    order = np.arange(len(ds))
    rng.shuffle(order)
    for start in range(0, len(ds) - batch_size + 1, batch_size):
        idx = order[start:start + batch_size].tolist()
        yield pack_pair_dataset_batch(ds, idx, num_tiles=num_tiles,
                                      supernode_fn=supernode_fn)


def make_packed_gwm_train_step(predictor, optimizer, class_num: int = 1,
                               loss: Callable = sigmoid_cross_entropy,
                               debug_checks: bool = False):
    """Train step for PackedGWMPairPredictor (models/gwm.py): the dense
    packed arg tuple with the per-molecule supernode table after adj.
    params/opt_state are donated — rebind from the returned tuple (see
    make_train_step)."""

    def loss_fn(params, atom_ids, adj, supers, mol_id, node_mask,
                left, right, labels):
        logits = predictor.apply(
            {"params": params}, atom_ids, adj, supers, mol_id, node_mask,
            left, right,
        )
        if class_num == 1:
            logits = jnp.reshape(logits, labels.shape)
        return loss(logits, labels), logits

    def step_fn(params, opt_state, atom_ids, adj, supers, mol_id, node_mask,
                left, right, labels):
        (l, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, atom_ids, adj, supers, mol_id, node_mask, left, right,
            labels,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, l, logits

    return _jit_step(step_fn, debug_checks, donate_argnums=(0, 1))


def make_packed_coo_train_step(coo_predictor, optimizer, class_num: int = 1,
                               loss: Callable = sigmoid_cross_entropy,
                               debug_checks: bool = False):
    """Train step over COO packed batches (PackedCOOBatch): the host ships
    ~#edges ints; the dense tile adjacency is materialized on device inside
    the step (models/packed.PackedPairPredictorCOO).  params/opt_state
    are donated — rebind from the returned tuple (see make_train_step)."""

    def loss_fn(params, args, labels):
        logits = coo_predictor.apply({"params": params}, *args)
        if class_num == 1:
            logits = jnp.reshape(logits, labels.shape)
        return loss(logits, labels), logits

    def step_fn(params, opt_state, args, labels):
        (l, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, args, labels
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, l, logits

    return _jit_step(step_fn, debug_checks, donate_argnums=(0, 1))


def make_packed_scan_train_step(predictor, optimizer,
                                class_num: int = 1,
                                loss: Callable = sigmoid_cross_entropy,
                                debug_checks: bool = False):
    """S train steps in ONE XLA program: ``lax.scan`` over a stack of S
    packed batches resident in HBM.  Works for both packed layouts —
    ``predictor`` is applied positionally to each step's arg tuple (the
    dense PackedPairPredictor 6-tuple or the wire-compact COO 5-tuple).
    One dispatch per S steps instead of S; params/opt_state buffers are
    donated so the update happens in place across the scan."""

    def loss_fn(params, args, labels):
        logits = predictor.apply({"params": params}, *args)
        if class_num == 1:
            logits = jnp.reshape(logits, labels.shape)
        return loss(logits, labels)

    def scan_fn(params, opt_state, stacked_args, stacked_labels):
        def body(carry, xs):
            p, s = carry
            args, labels = xs
            l, grads = jax.value_and_grad(loss_fn)(p, args, labels)
            updates, s = optimizer.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), l

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (stacked_args, stacked_labels)
        )
        return params, opt_state, losses

    return _jit_step(scan_fn, debug_checks, donate_argnums=(0, 1))


def scan_chunk_iterator(batches, scan_steps: int, args_fn):
    """Group a COO batch iterator into stacks of ``scan_steps`` batches
    (numpy-stacked wire arrays ready for one scan_fn call).  The tail
    chunk is dropped — like the per-epoch tail batch, those pairs return
    next epoch under the reshuffle."""
    chunk = []
    for b in batches:
        chunk.append(b)
        if len(chunk) == scan_steps:
            argses = [args_fn(c) for c in chunk]
            stacked = tuple(
                np.stack([a[i] for a in argses])
                for i in range(len(argses[0]))
            )
            labels = np.stack([c.labels for c in chunk])
            edges = int(sum(c.num_edges for c in chunk))
            yield stacked, labels, edges
            chunk = []


def _window_parallel(items, build, workers: int):
    """Yield build(item) in order with a ``workers``-deep lookahead on a
    thread pool.  Worth it when build releases the GIL (the native C++
    packer does, via ctypes) — packing overlaps the device step instead
    of serializing ahead of it."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = deque()
        try:
            for _ in range(workers + 1):
                pending.append(ex.submit(build, next(it)))
        except StopIteration:
            pass
        for item in it:
            out = pending.popleft().result()
            pending.append(ex.submit(build, item))
            yield out
        while pending:
            yield pending.popleft().result()


def packed_coo_batch_iterator(ds: PairDataset, batch_size: int,
                              num_tiles: int, edge_capacity: int,
                              rng: np.random.Generator, supernode_fn=None,
                              pack_workers: int = 4,
                              pack_cache: "list | None" = None,
                              pairlocal_parts: "int | None" = None):
    """Shuffled COO packed batches with fixed tile/edge capacities.  Uses
    the native C++ packer (native/pack.cpp) when available — the Python
    packer costs ~200 ms/2048-pair batch vs ~7 ms device step — and falls
    back to the Python spec implementation otherwise.  ``supernode_fn``
    attaches the per-molecule supernode table (GWM).  Packing runs
    ``pack_workers`` batches ahead on a thread pool (the native packer
    releases the GIL): on the bf16 scan path the ~6-9 ms serial pack had
    become the pipeline bottleneck (bench.py --sustained, DESIGN.md §5).

    ``pack_cache`` (round 4, VERDICT r3 #2): a caller-owned list.  When
    empty, this epoch's packed batches are appended to it as they are
    produced; when non-empty, the cached batches are yielded in a fresh
    random order WITHOUT re-packing — shuffling moves from pair level to
    batch level after epoch 1 (partition shuffling), which removes the
    per-epoch host pack cost entirely.  Trade-off documented in
    TrainConfig.reuse_packs; quality validated at reference scale
    (docs/QUALITY.md round-4 reuse-packs row).

    ``pairlocal_parts`` (round 5, VERDICT r4 #2): pack each batch
    device-locally for the pair-local co-attention edgeshard path
    (pack_pair_dataset_coo_pairlocal over ``pairlocal_parts`` buckets,
    per-part capacities ``num_tiles``/``edge_capacity`` — note these
    then mean PER-PART, not global, sizes)."""
    from gcnbmp_tpu.data import native_pack
    from gcnbmp_tpu.data.packing import (
        attach_supers_coo,
        pack_pair_dataset_coo,
        pack_pair_dataset_coo_pairlocal,
    )

    if pack_cache:
        for i in rng.permutation(len(pack_cache)):
            yield pack_cache[i]
        return

    cache = None
    if native_pack.native_pack_available():
        cache = getattr(ds, "_native_pack_cache", None)
        if cache is None:
            cache = native_pack.PairDatasetCache(ds)
            ds._native_pack_cache = cache
    order = np.arange(len(ds))
    rng.shuffle(order)

    def build(start):
        idx = order[start:start + batch_size].tolist()
        if pairlocal_parts:
            pf = None
            if cache is not None:
                pf = lambda i2, nt, ec: native_pack.pack_pairs_native(
                    cache, i2, num_tiles=nt, edge_capacity=ec)
            batch, _ = pack_pair_dataset_coo_pairlocal(
                ds, idx, pairlocal_parts, tiles_per_part=num_tiles,
                edge_capacity_per_part=edge_capacity, pack_fn=pf,
            )
        elif cache is not None:
            batch = native_pack.pack_pairs_native(
                cache, idx, num_tiles=num_tiles, edge_capacity=edge_capacity
            )
        else:
            batch = pack_pair_dataset_coo(
                ds, idx, num_tiles=num_tiles, edge_capacity=edge_capacity
            )
        if supernode_fn is not None:
            batch = attach_supers_coo(batch, ds, idx, supernode_fn)
        return batch

    starts = range(0, len(ds) - batch_size + 1, batch_size)
    if pack_workers > 1:
        produced = _window_parallel(starts, build, pack_workers)
    else:
        produced = (build(s) for s in starts)
    for b in produced:
        if pack_cache is not None:
            pack_cache.append(b)
        yield b


def make_eval_step_coo(coo_predictor):
    """Jitted eval over wire-compact COO batches (deterministic; the
    packed-compatible configs have no dropout by construction)."""

    @jax.jit
    def eval_fn(params, args):
        return coo_predictor.apply({"params": params}, *args)

    return eval_fn


def packed_config_problems(cfg, allow_attn: bool = False) -> List[str]:
    """The single source of truth for which configurations the packed
    compute paths support (used by the Trainer's check and by the eval
    CLIs' fast-path eligibility — keep them from drifting)."""
    from gcnbmp_tpu.models.packed import PACKED_ENCODERS

    problems = []
    if cfg.method == "ggnn-gwm":
        # the GWM packed twins: dense packed layout or wire-compact COO
        # (the per-molecule supernode table travels with the batch)
        if cfg.compute_path not in ("packed", "coo"):
            problems.append("ggnn-gwm rides compute_path 'packed' or 'coo'")
        if (getattr(cfg, "multi_device", False)
                and cfg.compute_path != "coo"):
            problems.append(
                "ggnn-gwm multi_device rides compute_path='coo' "
                "(owner-masked edgeshard)")
        if getattr(cfg, "scan_steps", 0) > 1 and cfg.compute_path != "coo":
            problems.append("ggnn-gwm scan mode requires compute_path='coo'")
    elif cfg.method not in PACKED_ENCODERS:
        problems.append(
            f"method={cfg.method!r} (only {'/'.join(PACKED_ENCODERS)}"
            f"/ggnn-gwm)"
        )
    if cfg.attn is not None and not allow_attn:
        problems.append("co-attention (use compute_path='coo')")
    if not cfg.siamese:
        problems.append("siamese=False")
    if cfg.symmetric is not None:
        problems.append("symmetric")
    if cfg.fp_dropout_rate > 0:
        problems.append("dropout")
    if cfg.fp_batch_normalization:
        problems.append("batch normalization")
    if cfg.concat_hidden:
        problems.append("concat_hidden")
    if cfg.layer_aggregator and cfg.method != "ggnn":
        problems.append("layer_aggregator (packed GGNN only)")
    return problems


def iter_coo_eval_batches(ds: PairDataset, batch_size: int, num_tiles: int,
                          edge_capacity: int, supernode_fn=None):
    """Sequential fixed-shape COO batches for full-dataset evaluation:
    yields (PackedCOOBatch, valid_count).  Tail batches are filled by
    repeating the dataset's SMALLEST pair (packing.smallest_pair_index)
    so the static capacity bounds computed for a worst-case full batch
    always hold; callers drop rows past valid_count.  Uses the native
    C++ packer when available (cached per dataset)."""
    from gcnbmp_tpu.data import native_pack
    from gcnbmp_tpu.data.packing import (
        pack_pair_dataset_coo,
        smallest_pair_index,
    )

    cache = None
    if native_pack.native_pack_available():
        cache = getattr(ds, "_native_pack_cache", None)
        if cache is None:
            cache = native_pack.PairDatasetCache(ds)
            ds._native_pack_cache = cache
    fill = smallest_pair_index(ds)
    n = len(ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        idx = idx + [fill] * (batch_size - valid)
        if cache is not None:
            batch = native_pack.pack_pairs_native(
                cache, idx, num_tiles=num_tiles, edge_capacity=edge_capacity
            )
        else:
            batch = pack_pair_dataset_coo(
                ds, idx, num_tiles=num_tiles, edge_capacity=edge_capacity
            )
        if supernode_fn is not None:
            from gcnbmp_tpu.data.packing import attach_supers_coo

            batch = attach_supers_coo(batch, ds, idx, supernode_fn)
        yield batch, valid


def collect_logits_coo(
    eval_fn, params, ds: PairDataset, batch_size: int, num_tiles: int,
    edge_capacity: int, args_fn=None, supernode_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full-dataset logits over the COO packed layout (fixed jit shapes
    via iter_coo_eval_batches).  ``args_fn`` maps a PackedCOOBatch to the
    predictor's positional args (default: the wire-compact encoding)."""
    from gcnbmp_tpu.models.packed import compact_coo_arrays

    if args_fn is None:
        args_fn = compact_coo_arrays

    logits_all: List[np.ndarray] = []
    labels_all: List[np.ndarray] = []
    for batch, valid in iter_coo_eval_batches(
        ds, batch_size, num_tiles, edge_capacity, supernode_fn=supernode_fn
    ):
        args = tuple(jnp.asarray(a) for a in args_fn(batch))
        out = eval_fn(params, args)
        labels = np.asarray(batch.labels)
        logits = np.asarray(out).reshape(labels.shape)
        logits_all.append(logits[:valid])
        labels_all.append(labels[:valid])
    return np.concatenate(logits_all, axis=0), np.concatenate(labels_all, axis=0)


def make_eval_step(predictor, uses_supernodes: bool = False):
    @jax.jit
    def eval_fn(params, atoms1, adj1, atoms2, adj2, mask1, mask2, supers):
        kwargs = {}
        if uses_supernodes:
            kwargs = {"super1": supers[0], "super2": supers[1]}
        return predictor.apply(
            {"params": params}, atoms1, adj1, atoms2, adj2, mask1, mask2,
            deterministic=True, **kwargs,
        )

    return eval_fn


def collect_logits(
    eval_fn, params, ds: PairDataset, batch_size: int, pad_to: Optional[int],
    supernode_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full-dataset logits (BatchEvaluator pattern)."""
    logits_all: List[np.ndarray] = []
    labels_all: List[np.ndarray] = []
    for batch in batch_iterator(
        ds, batch_size, shuffle=False, pad_to=pad_to, drop_remainder=False,
        supernode_fn=supernode_fn,
    ):
        supers = (
            (jnp.asarray(batch.super1), jnp.asarray(batch.super2))
            if batch.super1 is not None else ()
        )
        out = eval_fn(
            params, batch.atoms1, batch.adj1, batch.atoms2, batch.adj2,
            batch.mask1, batch.mask2, supers,
        )
        labels = np.asarray(batch.labels)
        logits = np.asarray(out).reshape(labels.shape)
        # drop fill rows (label -1) appended by the fixed-shape batcher
        valid = (labels >= 0).all(axis=-1) if labels.ndim > 1 else labels >= 0
        logits_all.append(logits[valid])
        labels_all.append(labels[valid])
    return np.concatenate(logits_all, axis=0), np.concatenate(labels_all, axis=0)


class Trainer:
    """Binary / multi-label DDI trainer.

    Usage::

        t = Trainer(config, train_ds, val_ds)
        result = t.fit()
    """

    def __init__(
        self,
        config: TrainConfig,
        train_ds: PairDataset,
        val_ds: Optional[PairDataset] = None,
        predictor=None,
    ):
        from gcnbmp_tpu.models import set_up_predictor

        self.config = config
        rng = np.random.default_rng(config.seed)
        if config.augment:
            train_ds = train_ds.augment_swap()
        if config.balance:
            train_ds = train_ds.rebalance(rng)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.np_rng = rng
        self.predictor = predictor or set_up_predictor(
            method=config.method,
            fp_hidden_dim=config.fp_hidden_dim,
            fp_out_dim=config.fp_out_dim,
            conv_layers=config.conv_layers,
            concat_hidden=config.concat_hidden,
            layer_aggregator=config.layer_aggregator,
            fp_dropout_rate=config.fp_dropout_rate,
            fp_batch_normalization=config.fp_batch_normalization,
            weight_tying=config.weight_tying,
            sim_method=config.sim_method,
            class_num=config.class_num,
            net_hidden_dims=config.net_hidden_dims,
            attn_model=config.attn,
            siamese=config.siamese,
            symmetric=config.symmetric,
            mask_padding=config.mask_padding,
        )
        # GWM supernode plumbing (reference train_ggnn_hole_with_gwm.py:321-347)
        self.uses_supernodes = config.method == "ggnn-gwm"
        self.supernode_fn = None
        if self.uses_supernodes:
            from gcnbmp_tpu.models.gwm import default_supernode_fn

            self.supernode_fn = default_supernode_fn()
        self.steps_per_epoch = max(1, len(self.train_ds) // config.batch_size)
        if config.scan_steps > 1 and config.scan_steps > self.steps_per_epoch:
            raise ValueError(
                f"scan_steps={config.scan_steps} exceeds the "
                f"{self.steps_per_epoch} batches per epoch "
                f"(dataset {len(self.train_ds)} pairs / batch_size "
                f"{config.batch_size}) — every epoch would train zero "
                "steps; lower scan_steps or batch_size")
        self.optimizer, self.schedule = build_optimizer(config, self.steps_per_epoch)
        # fixed pad size for the whole run -> one jit shape (each new
        # shape compiles anew; see data/dataset.py fill_batch_to)
        self.pad_to = config.max_pad
        if self.pad_to is None:
            from gcnbmp_tpu.data.dataset import bucket_size

            m = self.train_ds.max_atoms()
            if val_ds is not None and len(val_ds):
                m = max(m, val_ds.max_atoms())
            self.pad_to = bucket_size(m)
        self.log: List[Dict[str, Any]] = []

    def _init_state(self) -> TrainState:
        cfg = self.config
        rng = jax.random.PRNGKey(cfg.seed)
        init_batch = make_batch(
            self.train_ds, list(range(min(2, len(self.train_ds)))),
            pad_to=self.pad_to, supernode_fn=self.supernode_fn,
        )
        init_kwargs = {}
        if self.uses_supernodes:
            init_kwargs = {
                "super1": jnp.asarray(init_batch.super1),
                "super2": jnp.asarray(init_batch.super2),
            }
        variables = self.predictor.init(
            rng,
            jnp.asarray(init_batch.atoms1), jnp.asarray(init_batch.adj1),
            jnp.asarray(init_batch.atoms2), jnp.asarray(init_batch.adj2),
            jnp.asarray(init_batch.mask1), jnp.asarray(init_batch.mask2),
            **init_kwargs,
        )
        params = variables["params"]
        opt_state = self.optimizer.init(params)
        return TrainState(params, opt_state, 0, 0, float("inf"), 0)

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.config
        state = self._init_state()
        if cfg.resume:
            from gcnbmp_tpu.train.checkpoints import restore_checkpoint

            state = restore_checkpoint(cfg.resume, state)
            logger.info("resumed from %s at epoch %d", cfg.resume, state.epoch)
        loss_kwargs = (
            {"gamma": cfg.focal_gamma, "alpha": cfg.focal_alpha}
            if cfg.loss == "focal" else {}
        )
        # epoch-1 packed batches, reused (batch-level reshuffle) when
        # cfg.reuse_packs — see packed_coo_batch_iterator
        self._pack_cache = [] if cfg.reuse_packs else None
        self.loss_fn = make_loss(cfg.loss, **loss_kwargs)
        packed = cfg.compute_path in ("packed", "coo")
        if cfg.multi_device and cfg.compute_path not in ("packed", "coo"):
            raise ValueError(
                "multi_device requires compute_path 'packed' or 'coo'")
        coo = cfg.compute_path == "coo"
        if packed:
            # co-attention rides the packed layout on the coo path only
            self._check_packed_compatible(
                allow_attn=cfg.compute_path == "coo")
            from gcnbmp_tpu.models.packed import make_packed_predictor

            adj_dtype = (
                jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
            )
            # dense-Set2Set atom-table width for MPNN: the measured
            # largest molecule across the run's datasets (lane-rounded)
            # instead of the safe-but-4x-amplified 64 default
            s2s_n_max = 64
            if cfg.method == "mpnn":
                from gcnbmp_tpu.data.packing import max_atoms_lane_rounded

                dss = [self.train_ds]
                if self.val_ds is not None and len(self.val_ds):
                    dss.append(self.val_ds)
                s2s_n_max = max_atoms_lane_rounded(dss)
            packed_predictor = make_packed_predictor(
                fp_hidden_dim=cfg.fp_hidden_dim, fp_out_dim=cfg.fp_out_dim,
                conv_layers=cfg.conv_layers, weight_tying=cfg.weight_tying,
                sim_method=cfg.sim_method, class_num=cfg.class_num,
                net_hidden_dims=cfg.net_hidden_dims, compact=coo,
                attn=cfg.attn if coo else None, adj_dtype=adj_dtype,
                method=cfg.method,
                layer_aggregator=cfg.layer_aggregator,
                s2s_n_max=s2s_n_max,
                # VJP mode follows the execution mode (round 5): the
                # gather-only table VJP per step, the scatter form
                # under single-device lax.scan
                gather_vjp=(False if (cfg.attn and cfg.scan_steps > 1
                                      and not cfg.multi_device)
                            else None),
                # bfloat16: message/GRU matmuls in bf16 with f32
                # accumulation (params and the head stay f32).
                compute_dtype=(
                    jnp.bfloat16
                    if cfg.compute_dtype == "bfloat16"
                    and cfg.method in ("ggnn", "relgcn", "gin", "mpnn")
                    else None
                ),
            )
            if cfg.multi_device and cfg.scan_steps > 1 \
                    and cfg.compute_path != "coo":
                raise ValueError(
                    "multi_device scan mode rides compute_path='coo'")
            if coo and cfg.multi_device:
                # graph-sharded training over the sustained COO input
                # path: each device scatter-builds its local tile
                # adjacency from its edge shard (parallel/edgeshard.py).
                # Round 4 (VERDICT r3 #4): this runs the PRODUCTION
                # configuration — bf16 compute_dtype rides the
                # predictor, scan_steps composes via
                # make_edgeshard_scan_train_step, co-attention completes
                # the atom table with one all_gather, GWM contributes
                # owner-masked supernode embeddings, and focal/hinge
                # losses reduce through the same global-mean psums.
                import numpy as _np

                from gcnbmp_tpu.parallel.edgeshard import (
                    elementwise_loss_for,
                    make_edgeshard_coattn_loss,
                    make_edgeshard_coo_loss,
                    make_edgeshard_gwm_loss,
                    make_edgeshard_scan_train_step,
                    make_edgeshard_train_step_from_loss,
                    pad_partition_coattn,
                    pad_partition_coo,
                    pad_partition_gwm,
                    shard_packed_coattn_batch,
                    shard_packed_coo_batch,
                    shard_packed_gwm_batch,
                )

                self._mesh = jax.sharding.Mesh(
                    _np.asarray(jax.devices()), ("graph",)
                )
                n_dev = len(jax.devices())
                if cfg.scan_steps > 1 and cfg.batch_size % n_dev:
                    raise ValueError(
                        "multi_device scan mode requires batch_size "
                        f"divisible by the device count ({n_dev})")
                elem_loss = elementwise_loss_for(cfg.loss, **loss_kwargs)
                # static per-shard edge capacity: the GLOBAL capacity
                # (always sufficient — no data-dependent mid-training
                # failure; edge arrays are small, so the extra masked
                # scatter input is cheap relative to a ValueError hours
                # into a run).  self.edge_capacity is set right after
                # this dispatch block; the closures read it lazily.
                cap = lambda: ((self.edge_capacity + 127) // 128) * 128
                self._stack_replicated = ()
                if self.uses_supernodes:
                    loss_fn = make_edgeshard_gwm_loss(
                        packed_predictor, self._mesh, axis="graph",
                        elementwise_loss=elem_loss,
                    )
                    self._shard_batch = lambda b: shard_packed_gwm_batch(
                        b, self._mesh, axis="graph",
                        edge_capacity_per_shard=cap(),
                    )
                    self._partition_batch = lambda b: pad_partition_gwm(
                        b, n_dev, edge_capacity_per_shard=cap())
                    from gcnbmp_tpu.parallel.edgeshard import (
                        GWM_SUPERS_INDEX,
                    )

                    self._stack_replicated = (GWM_SUPERS_INDEX,)
                elif cfg.attn is not None:
                    # n_max for the pair atom-slot tables, same bound
                    # the single-device co-attention path uses (set
                    # below from the datasets); read lazily.
                    # Round 5 (VERDICT r4 #2): pair-LOCAL packing is the
                    # default — both molecules of every pair land on one
                    # device, deleting the atom-table all_gather and the
                    # molecule-table psum outright
                    # (GCNBMP_COATTN_PAIRLOCAL=0 restores the legacy
                    # all_gather path for A/Bs).
                    self._coattn_pairlocal = (
                        os.environ.get("GCNBMP_COATTN_PAIRLOCAL", "1")
                        != "0")
                    loss_fn = make_edgeshard_coattn_loss(
                        packed_predictor, self._mesh, axis="graph",
                        elementwise_loss=elem_loss,
                        pair_local=self._coattn_pairlocal,
                    )
                    if self._coattn_pairlocal:
                        from gcnbmp_tpu.parallel.edgeshard import (
                            pad_partition_coattn_pairlocal,
                            shard_packed_coattn_batch_pairlocal,
                        )

                        # self._pairlocal_meta is set with the per-part
                        # capacities right after this dispatch block
                        self._shard_batch = (
                            lambda b: shard_packed_coattn_batch_pairlocal(
                                b, self._pairlocal_meta, self._mesh,
                                axis="graph", n_max=self._coattn_n_max,
                            )
                        )
                        self._partition_batch = (
                            lambda b: pad_partition_coattn_pairlocal(
                                b, self._pairlocal_meta,
                                self._coattn_n_max)
                        )
                    else:
                        self._shard_batch = (
                            lambda b: shard_packed_coattn_batch(
                                b, self._mesh, axis="graph",
                                n_max=self._coattn_n_max,
                                edge_capacity_per_shard=cap(),
                            )
                        )
                        self._partition_batch = (
                            lambda b: pad_partition_coattn(
                                b, n_dev, self._coattn_n_max,
                                edge_capacity_per_shard=cap())
                        )
                else:
                    loss_fn = make_edgeshard_coo_loss(
                        packed_predictor, self._mesh, axis="graph",
                        elementwise_loss=elem_loss,
                    )
                    self._shard_batch = lambda b: shard_packed_coo_batch(
                        b, self._mesh, axis="graph",
                        edge_capacity_per_shard=cap(),
                    )
                    self._partition_batch = lambda b: pad_partition_coo(
                        b, n_dev, edge_capacity_per_shard=cap())
                if cfg.scan_steps > 1:
                    train_step = make_edgeshard_scan_train_step(
                        loss_fn, self.optimizer)
                else:
                    train_step = make_edgeshard_train_step_from_loss(
                        loss_fn, self.optimizer)
                logging.info(
                    "multi_device: COO graph-sharded training over %d "
                    "devices (scan_steps=%d, loss=%s, attn=%s, gwm=%s)",
                    n_dev, cfg.scan_steps, cfg.loss, cfg.attn,
                    self.uses_supernodes,
                )
            elif cfg.scan_steps > 1:
                train_step = make_packed_scan_train_step(
                    packed_predictor, self.optimizer, cfg.class_num,
                    self.loss_fn, debug_checks=cfg.debug_checks,
                )
            elif coo:
                train_step = make_packed_coo_train_step(
                    packed_predictor, self.optimizer, cfg.class_num,
                    self.loss_fn, debug_checks=cfg.debug_checks,
                )
            elif cfg.multi_device:
                # graph-sharded data parallelism over every visible device
                # (reference --multi-gpu ParallelUpdater,
                # train_ddi_modify_eval2.py:583-586 — re-designed as
                # zero-cut-edge tile sharding, parallel/edgeshard.py)
                if cfg.compute_path != "packed":
                    raise ValueError(
                        "multi_device requires compute_path='packed'")
                if cfg.class_num != 1 or cfg.loss != "sigmoid_ce":
                    raise ValueError(
                        "multi_device supports binary sigmoid-CE only")
                import numpy as _np

                from gcnbmp_tpu.parallel.edgeshard import (
                    make_edgeshard_train_step,
                    shard_packed_batch,
                )

                self._mesh = jax.sharding.Mesh(
                    _np.asarray(jax.devices()), ("graph",)
                )
                self._shard_batch = lambda b: shard_packed_batch(
                    b, self._mesh, axis="graph"
                )
                train_step = make_edgeshard_train_step(
                    packed_predictor, self.optimizer, self._mesh,
                    axis="graph",
                )
                logging.info(
                    "multi_device: graph-sharded training over %d devices",
                    len(jax.devices()),
                )
            elif cfg.method == "ggnn-gwm":
                train_step = make_packed_gwm_train_step(
                    packed_predictor, self.optimizer,
                    cfg.class_num, self.loss_fn,
                    debug_checks=cfg.debug_checks,
                )
            else:
                train_step = make_packed_train_step(
                    packed_predictor, self.optimizer,
                    cfg.class_num, self.loss_fn,
                    debug_checks=cfg.debug_checks,
                )
            # safe static bounds over every dataset the jitted programs
            # will see (train batches are shuffled; eval batches are
            # sequential — both are covered by the worst-case batch)
            from gcnbmp_tpu.data.packing import estimate_coo_capacities

            eval_datasets = [self.train_ds]
            if self.val_ds is not None and len(self.val_ds):
                eval_datasets.append(self.val_ds)
            self.num_tiles, self.edge_capacity = estimate_coo_capacities(
                eval_datasets, cfg.batch_size
            )
            self._pairlocal_meta = None
            if getattr(self, "_coattn_pairlocal", False):
                # per-PART static capacities for the pair-local packer:
                # the worst bucket cannot exceed the worst
                # pairs_per_part-pair batch (LPT keeps buckets at most
                # that large), so the same worst-case estimator applies
                # at bucket granularity
                from gcnbmp_tpu.data.packing import PairLocalMeta

                n_dev = len(jax.devices())
                ppp = -(-cfg.batch_size // n_dev)
                tpp, ecpp = estimate_coo_capacities(eval_datasets, ppp)
                ecpp = ((ecpp + 127) // 128) * 128
                self._pairlocal_meta = PairLocalMeta(
                    n_parts=n_dev, tiles_per_part=tpp,
                    pairs_per_part=ppp, edge_capacity_per_part=ecpp,
                )
            if coo:
                from gcnbmp_tpu.models.packed import (
                    compact_coattn_arrays,
                    compact_coo_arrays,
                    compact_gwm_arrays,
                )

                if self.uses_supernodes:
                    coo_args_fn = compact_gwm_arrays
                elif cfg.attn is not None:
                    from gcnbmp_tpu.data.packing import (
                        max_atoms_lane_rounded,
                    )

                    n_max = max_atoms_lane_rounded(eval_datasets)
                    self._coattn_n_max = n_max  # read by the edgeshard
                    coo_args_fn = (                # partition closures
                        lambda b: compact_coattn_arrays(b, n_max)
                    )
                else:
                    coo_args_fn = compact_coo_arrays
        else:
            train_step = make_train_step(
                self.predictor, self.optimizer, cfg.class_num, self.loss_fn,
                uses_supernodes=self.uses_supernodes,
                debug_checks=cfg.debug_checks,
            )
        if coo:
            # epoch-end metric evals ride the fast COO path too
            eval_step_coo = make_eval_step_coo(packed_predictor)

            def run_eval(ds):
                # multi_device params live replicated on the mesh; pull
                # them host-side ONCE and stage on the default device so
                # per-batch eval calls don't re-transfer the tree
                p = state.params
                if cfg.multi_device:
                    p = jax.device_put(
                        jax.device_get(state.params), jax.devices()[0]
                    )
                return collect_logits_coo(
                    eval_step_coo, p, ds, cfg.batch_size,
                    self.num_tiles, self.edge_capacity, args_fn=coo_args_fn,
                    supernode_fn=self.supernode_fn,
                )
        else:
            eval_step = make_eval_step(self.predictor, self.uses_supernodes)

            def run_eval(ds):
                # multi_device params live replicated on the mesh; pull
                # them host-side ONCE and stage on the default device so
                # per-batch eval calls don't re-transfer the tree
                p = state.params
                if cfg.multi_device:
                    p = jax.device_put(
                        jax.device_get(state.params), jax.devices()[0]
                    )
                return collect_logits(
                    eval_step, p, ds, cfg.batch_size,
                    self.pad_to, supernode_fn=self.supernode_fn,
                )
        dropout_rng = jax.random.PRNGKey(cfg.seed + 1)

        os.makedirs(cfg.out_dir, exist_ok=True)
        max_epochs = max_epochs or cfg.epochs
        t0 = time.time()
        for epoch in range(state.epoch, max_epochs):
            # optional jax.profiler trace of one epoch (SURVEY §5.1;
            # the reference has no tracing story at all)
            profiling = cfg.profile_epoch is not None and epoch == cfg.profile_epoch
            if profiling:
                logging.info("profiling epoch %d into %s", epoch,
                             os.path.join(cfg.out_dir, "profile"))
                jax.profiler.start_trace(os.path.join(cfg.out_dir, "profile"))
            epoch_losses = []
            dispatch_s = []
            epoch_edges = 0
            epoch_t0 = time.time()
            if coo:
                plm = getattr(self, "_pairlocal_meta", None)
                batches = packed_coo_batch_iterator(
                    self.train_ds, cfg.batch_size,
                    plm.tiles_per_part if plm else self.num_tiles,
                    plm.edge_capacity_per_part if plm else self.edge_capacity,
                    self.np_rng,
                    supernode_fn=self.supernode_fn,
                    pack_workers=cfg.pack_workers,
                    pack_cache=self._pack_cache,
                    pairlocal_parts=plm.n_parts if plm else None,
                )
                if cfg.debug_checks:
                    batches = (b.validate() for b in batches)
            elif packed:
                batches = packed_batch_iterator(
                    self.train_ds, cfg.batch_size, self.num_tiles,
                    self.np_rng, supernode_fn=self.supernode_fn,
                )
            else:
                batches = batch_iterator(
                    self.train_ds, cfg.batch_size, shuffle=True,
                    rng=self.np_rng, pad_to=self.pad_to, drop_remainder=True,
                    supernode_fn=self.supernode_fn,
                )
            scanning = packed and cfg.scan_steps > 1
            if scanning:
                if coo and cfg.multi_device:
                    # pre-partitioned global arrays (labels stripped —
                    # batch_size % n_dev == 0 is enforced, so the
                    # partition adds no pair padding and the raw labels
                    # stack matches)
                    scan_args_fn = lambda b: self._partition_batch(b)[:-1]
                elif coo:
                    scan_args_fn = coo_args_fn
                else:
                    adj_np_dtype = (
                        np.float32 if cfg.compute_dtype == "float32"
                        else jnp.bfloat16
                    )
                    scan_args_fn = lambda b: (
                        b.atom_ids, np.asarray(b.adj, adj_np_dtype), b.mol_id,
                        b.node_mask, b.left_index, b.right_index,
                    )
                batches = scan_chunk_iterator(
                    batches, cfg.scan_steps, scan_args_fn
                )
            if cfg.prefetch > 0:
                from gcnbmp_tpu.data.prefetch import PrefetchIterator

                transfer = None
                if scanning and cfg.multi_device:
                    def transfer(item):
                        stacked, labels, edges = item
                        args, lab = self._put_stacked_sharded(
                            stacked, labels)
                        return (args, lab, edges)
                elif scanning:
                    def transfer(item):
                        stacked, labels, edges = item
                        return (
                            jax.device_put(stacked),
                            jax.device_put(labels),
                            edges,
                        )
                elif coo and cfg.multi_device:
                    # run the host-side edge partitioning + sharded
                    # device_puts on the prefetch thread so they overlap
                    # with the device step (same rationale as below)
                    def transfer(b):
                        return (self._shard_batch(b), b.num_edges)
                elif coo:
                    # stage host->device transfers on the prefetch thread so
                    # they overlap with the device step; ship the
                    # wire-compact encoding (bit-packed edges, masks
                    # derived on device)
                    def transfer(b):
                        return (
                            jax.device_put(coo_args_fn(b)),
                            jax.device_put(b.labels),
                            b.num_edges,
                        )

                batches = PrefetchIterator(
                    batches, depth=cfg.prefetch, transfer=transfer,
                    workers=cfg.prefetch_workers if coo else 1,
                )
            for batch in batches:
                t_dispatch = time.perf_counter()
                if scanning:
                    stacked, labels, batch_edges = batch
                    if (cfg.multi_device
                            and not isinstance(stacked[0], jax.Array)):
                        # no prefetcher staged it — shard here
                        stacked, labels = self._put_stacked_sharded(
                            stacked, labels)
                    state.params, state.opt_state, losses = train_step(
                        state.params, state.opt_state,
                        tuple(jnp.asarray(a) for a in stacked),
                        jnp.asarray(labels),
                    )
                    epoch_losses.append(losses)  # (S,) on device
                    epoch_edges += batch_edges
                    state.step += cfg.scan_steps
                    if cfg.step_log:
                        jax.block_until_ready(losses)
                        dispatch_s.append(time.perf_counter() - t_dispatch)
                    continue
                if coo and cfg.multi_device:
                    if isinstance(batch, tuple):  # staged by the prefetcher
                        sharded, batch_edges = batch
                    else:
                        sharded = self._shard_batch(batch)
                        batch_edges = batch.num_edges
                    state.params, state.opt_state, loss = train_step(
                        state.params, state.opt_state, *sharded,
                    )
                elif coo:
                    if isinstance(batch, tuple):  # staged by the prefetcher
                        args, labels, batch_edges = batch
                    else:
                        args = tuple(
                            jnp.asarray(a) for a in coo_args_fn(batch)
                        )
                        labels = jnp.asarray(batch.labels)
                        batch_edges = batch.num_edges
                    state.params, state.opt_state, loss, _ = train_step(
                        state.params, state.opt_state, args, labels,
                    )
                elif packed and cfg.multi_device:
                    state.params, state.opt_state, loss = train_step(
                        state.params, state.opt_state,
                        *self._shard_batch(batch),
                    )
                elif packed:
                    # bf16 adjacency is exact (0/1 values) and halves
                    # the transfer/storage when requested
                    adj_dtype = (
                        np.float32 if cfg.compute_dtype == "float32"
                        else jnp.bfloat16
                    )
                    supers = (
                        (jnp.asarray(batch.supers),)
                        if self.uses_supernodes else ()
                    )
                    state.params, state.opt_state, loss, _ = train_step(
                        state.params, state.opt_state,
                        jnp.asarray(batch.atom_ids),
                        # cast HOST-side so bf16 actually halves the transfer
                        jnp.asarray(np.asarray(batch.adj, adj_dtype)),
                        *supers,
                        jnp.asarray(batch.mol_id), jnp.asarray(batch.node_mask),
                        jnp.asarray(batch.left_index),
                        jnp.asarray(batch.right_index),
                        jnp.asarray(batch.labels),
                    )
                else:
                    dropout_rng, sub = jax.random.split(dropout_rng)
                    supers = (
                        (jnp.asarray(batch.super1), jnp.asarray(batch.super2))
                        if batch.super1 is not None else ()
                    )
                    state.params, state.opt_state, loss, _ = train_step(
                        state.params, state.opt_state,
                        jnp.asarray(batch.atoms1), jnp.asarray(batch.adj1),
                        jnp.asarray(batch.atoms2), jnp.asarray(batch.adj2),
                        jnp.asarray(batch.mask1), jnp.asarray(batch.mask2),
                        supers, jnp.asarray(batch.labels), sub,
                    )
                # keep the loss on device — a per-step float() fetch
                # waits for the device and serializes the pipeline;
                # fetch once per epoch instead
                epoch_losses.append(loss)
                epoch_edges += batch_edges if coo else batch.num_edges
                state.step += 1
                if cfg.step_log:
                    jax.block_until_ready(loss)
                    dispatch_s.append(time.perf_counter() - t_dispatch)
            if epoch_losses:
                epoch_losses = np.asarray(
                    jnp.concatenate([jnp.atleast_1d(l) for l in epoch_losses]),
                    np.float64,
                ).tolist()
                if cfg.check_numerics and not np.all(np.isfinite(epoch_losses)):
                    bad = int(np.argmax(~np.isfinite(epoch_losses)))
                    raise FloatingPointError(
                        f"non-finite loss {epoch_losses[bad]} at epoch "
                        f"{epoch} step {bad}"
                    )
            epoch_dt = max(time.time() - epoch_t0, 1e-9)
            if profiling:
                jax.profiler.stop_trace()
            state.epoch = epoch + 1

            entry: Dict[str, Any] = {
                "epoch": state.epoch,
                "main/loss": float(np.mean(epoch_losses)) if epoch_losses else None,
                "lr": float(self.schedule(state.step)),
                "elapsed_time": time.time() - t0,
                "edges_per_s": epoch_edges / epoch_dt,
            }
            if cfg.step_log:
                entry["dispatch_s"] = dispatch_s
                entry["step_losses"] = epoch_losses
            # epoch-end evaluators on train & val (reference :607-671)
            if cfg.eval_train:
                tr_logits, tr_labels = run_eval(self.train_ds)
                for k, v in compute_metrics(
                    tr_logits, tr_labels, cfg.class_num
                ).items():
                    entry[f"train/{k}"] = v
            val_loss = None
            if self.val_ds is not None and len(self.val_ds):
                v_logits, v_labels = run_eval(self.val_ds)
                val_loss = float(
                    self.loss_fn(
                        jnp.asarray(v_logits.reshape(v_labels.shape)),
                        jnp.asarray(v_labels),
                    )
                )
                entry["val/loss"] = val_loss
                for k, v in compute_metrics(v_logits, v_labels, cfg.class_num).items():
                    entry[f"val/{k}"] = v
            self.log.append(entry)
            logger.info("%s", json.dumps(entry))
            with open(os.path.join(cfg.out_dir, "log.json"), "w") as f:
                json.dump(self.log, f, indent=2)
            if cfg.plot_reports and state.epoch % cfg.snapshot_interval == 0:
                self._write_plots(cfg.out_dir)

            if state.epoch % cfg.snapshot_interval == 0:
                from gcnbmp_tpu.train.checkpoints import save_checkpoint

                save_checkpoint(
                    os.path.join(cfg.out_dir, f"snapshot_epoch_{state.epoch}"), state
                )

            # early stopping on val loss (reference :595, patience 10)
            if val_loss is not None:
                if val_loss < state.best_val_loss - 1e-12:
                    state.best_val_loss = val_loss
                    state.epochs_since_best = 0
                    from gcnbmp_tpu.train.checkpoints import save_checkpoint

                    save_checkpoint(os.path.join(cfg.out_dir, "best"), state)
                else:
                    state.epochs_since_best += 1
                    if state.epochs_since_best >= cfg.early_stop_patience:
                        logger.info(
                            "early stop at epoch %d (best val loss %.5f)",
                            state.epoch, state.best_val_loss,
                        )
                        break

        from gcnbmp_tpu.train.checkpoints import save_checkpoint

        save_checkpoint(os.path.join(cfg.out_dir, "final"), state)
        return {"state": state, "log": self.log}

    def _put_stacked_sharded(self, stacked, labels):
        """Device-place a scan chunk for the multi-device edgeshard scan
        step: scan dim unsharded, shard axis on dim 1; arrays listed in
        ``_stack_replicated`` (the GWM supernode table) ride replicated."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(self._mesh, P(None, "graph"))
        sh_rep = NamedSharding(self._mesh, P())
        args = tuple(
            jax.device_put(jnp.asarray(a),
                           sh_rep if i in self._stack_replicated else sh)
            for i, a in enumerate(stacked)
        )
        return args, jax.device_put(jnp.asarray(labels), sh)

    def _check_packed_compatible(self, allow_attn: bool = False) -> None:
        problems = packed_config_problems(self.config, allow_attn=allow_attn)
        if problems:
            raise ValueError(
                "compute_path='packed'/'coo' supports the plain Siamese "
                "GGNN/RelGCN/GIN configurations only; incompatible options: "
                + ", ".join(problems)
            )

    def _write_plots(self, out_dir: str) -> None:
        """loss.png / accuracy.png (the reference's PlotReport outputs,
        train_ddi_modify_eval2.py:704-705)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # pragma: no cover
            return
        epochs = [e["epoch"] for e in self.log]
        for fname, keys in (
            ("loss.png", ["main/loss", "val/loss"]),
            ("accuracy.png", ["train/accuracy", "val/accuracy"]),
        ):
            fig, ax = plt.subplots(figsize=(6, 4))
            plotted = False
            for k in keys:
                ys = [e.get(k) for e in self.log]
                if any(y is not None for y in ys):
                    ax.plot(epochs, [y if y is not None else float("nan") for y in ys],
                            label=k)
                    plotted = True
            if plotted:
                ax.set_xlabel("epoch")
                ax.legend()
                fig.savefig(os.path.join(out_dir, fname), dpi=80)
            plt.close(fig)
