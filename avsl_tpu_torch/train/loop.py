"""Train and eval steps: gradient accumulation, clipping and AdamW, on one
device or on a (data, model), (data, expert) or (data, stage) mesh.

Port of ``avsl_tpu/train/loop.py``. The JAX step is one jit program that
scans over micro-batches; here it is a Python loop of forward/backward
passes, which is what the scan computes:

* a batch whose leaves carry a leading ``[accum, micro, ...]`` axis runs
  ``accum`` micro-steps; the gradients of each micro-batch's mean loss
  are summed in the parameters' dtype, then divided by ``accum``, and the
  reported metrics are the means over the micro-steps;
* the ``grad_norm`` metric is the global norm of those gradients before
  clipping (the optimizer clips); under :class:`MultiSteps` it stays the
  micro-batch's, while the clip takes the norm of the accumulated mean;
* ``param_labels`` (from :func:`avsl_tpu_torch.train.optim.select_optimizer`)
  sets ``requires_grad=False`` on the frozen parameters, so no backward
  runs through frozen-only subgraphs (the JAX step differentiates only the
  trainable subtree);
* random draws (dropout, SpecAugment, the AV-mode draw) come from the
  state's ``torch.Generator``, in order;
* BatchNorm statistics live in the model's buffers, so a micro-step that
  updates them hands them to the next, as the JAX scan carries them;
* ``precompute_fn`` (the frozen-tower hoist) runs once a step, before the
  micro-steps and without gradients, on the whole stacked batch, and its
  context is merged into each micro-batch.

On a mesh (one process per rank, ``core/mesh.py``) the step takes the
global batch, as JAX's does, and computes what JAX's SPMD program
computes, the single-device step on that batch:

* each data rank takes its rows (:func:`~avsl_tpu_torch.core.mesh.shard_batch`;
  a batch that does not divide the data axis is given whole to every
  rank); a state not yet on the mesh is put there first
  (:func:`~avsl_tpu_torch.core.partitioning.shard_state` with ``zero1``
  and ``fsdp``, tensor parallelism from the rules when the model axis is
  above 1);
* the loss is the token mean of the global batch: each micro-step sums
  the valid-label count over the data ranks and scales the rank's mean by
  ``local count x dp / global count``, so the mean over ranks of the
  gradients (an all-reduce after the micro-steps, or FSDP's
  reduce-scatter) and of the ``loss`` metric is the global one;
* BatchNorm in training reduces its statistics over the data ranks, row
  draws are made at the global batch's shape and an MoE layer routes the
  global tokens (:func:`~avsl_tpu_torch.core.mesh.row_shard_scope`, over
  the data group only: the ranks of an expert or model row hold the same
  rows), so dropout masks differ across data ranks while LayerDrop and
  the AV-mode draw agree on every rank of both axes.

On a stage mesh (pipeline parallelism, ``core/pipeline.py``) the state
is put there first by :func:`~avsl_tpu_torch.train.pp.shard_pp_state`
(each stage keeps its rows of the stacked blocks and of their moments;
``shard_state`` refuses the mesh). The loss's ``pipeline_apply`` returns
the same output on every stage rank, and its backward gives every
replicated tensor the same gradient there, so the step reduces gradients
over the data group only; the gradient norm adds the block slices'
squared sums over the stage group.

Sequence parallelism (``sequence_parallel``; None, JAX's default, turns
it on when the mesh's model axis is above 1): the step enters
:func:`~avsl_tpu_torch.core.mesh.activation_sharding_scope` itself, around
its forward and backward passes, so every call carries it whatever the
caller's context; the encoders then split their activations over T on the
model group between blocks (``core/mesh.py``). It moves no number beyond
the order of a few fp32 sums; at a model axis of 1 it splits nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from avsl_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    RowShard,
    ShardedBatch,
    activation_sharding_scope,
    row_shard_scope,
    shard_batch,
)
from avsl_tpu_torch.core.partitioning import local_tensor, shard_state
from avsl_tpu_torch.train.optim import TRAIN, ClippedAdamW, MultiSteps, global_norm
from avsl_tpu_torch.utils.spans import count, span

# loss_fn(batch, generator) -> (loss, metrics dict), over the state's model
LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# precompute_fn(batch, generator) -> context dict (leading [accum] axis)
PrecomputeFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]],
                        Dict[str, torch.Tensor]]


# labels the loss ignores (``models/avhubert.py::cross_entropy_loss``)
IGNORE_INDEX = -100
# elements per all-reduce of the gradients
_BUCKET_ELEMENTS = 1 << 26


def sp_scope(mesh, sequence_parallel: Optional[bool]):
    """The activation-sharding scope of a step (``avsl_tpu/train/loop.py:
    33-49``): None turns it on when ``mesh`` has a model axis above 1; off,
    or without a mesh, a scope that splits nothing."""
    if sequence_parallel is None:
        sequence_parallel = mesh is not None and mesh.shape.get(MODEL_AXIS, 1) > 1
    return activation_sharding_scope(mesh if sequence_parallel else None)


@dataclass
class TrainState:
    """The model (parameters in place), its optimizer, the update count,
    and the generator every random draw of a step comes from (seeded alike
    on every rank of a mesh); on a mesh, the state's
    :class:`~avsl_tpu_torch.core.partitioning.Layout` there."""

    model: nn.Module
    optimizer: Optional[Union[ClippedAdamW, MultiSteps]]
    step: int = 0
    generator: Optional[torch.Generator] = None
    layout: Any = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optional[Union[ClippedAdamW, MultiSteps]],
               seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(model=model, optimizer=optimizer, step=0, generator=gen)


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays and tensors -> tensors on ``device`` (integers as
    int64, floats kept); the bytes of the host arrays and of tensors on
    another device are counted as ``h2d_bytes``."""
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        if not isinstance(value, torch.Tensor) or value.device != device:
            count("h2d_bytes", t.nbytes)
        out[key] = t.to(device, non_blocking=True)
    return out


def _all_reduce_mean(tensors: List[torch.Tensor], group, n: int) -> None:
    """Average ``tensors`` in place over the ``n`` ranks of ``group``, in
    flat buckets of one dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        bucket, size = [], 0
        for t in group_tensors + [None]:
            if t is not None:
                bucket.append(t)
                size += t.numel()
            if bucket and (t is None or size >= _BUCKET_ELEMENTS):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                flat.div_(n)
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0


def _rows(mesh, batch: ShardedBatch, groups: int = 1) -> Optional[RowShard]:
    """The :class:`RowShard` of a sharded batch on a data axis above 1
    (None when the labels were given whole to every rank)."""
    if mesh is None or mesh.shape[DATA_AXIS] <= 1 or "labels" not in batch.sharded:
        return None
    return RowShard(mesh.data_group, mesh.data_rank, mesh.shape[DATA_AXIS], groups)


def _token_scale(rows: RowShard, labels: torch.Tensor) -> torch.Tensor:
    """``local count x dp / global count`` of valid labels: the factor
    that turns this rank's token mean into its share of the global token
    mean."""
    local = (labels != IGNORE_INDEX).sum().float()
    total = local.clone()
    dist.all_reduce(total, group=rows.group)
    return local.clamp_min(1.0) * rows.size / total.clamp_min(1.0)


def _prepare(state: "TrainState", mesh, batch: Dict[str, Any], batch_dim: int,
             zero1: bool, fsdp: bool) -> Tuple[Dict[str, torch.Tensor], Optional[ShardedBatch]]:
    """The batch on the state's device: this rank's rows of it on a mesh
    (the state put on the mesh first when it is not yet), as it is
    otherwise. Returns ``(batch, sharded batch or None)``."""
    with span("train.upload"):
        if mesh is None:
            return batch_to_device(batch, next(state.model.parameters()).device), None
        if state.layout is None:
            shard_state(state, mesh, zero1=zero1, fsdp=fsdp)
        if not isinstance(batch, ShardedBatch):
            batch = shard_batch(mesh, batch, batch_dim)
        return dict(batch), batch


def make_train_step(
    loss_fn: LossFn,
    mesh: Any = None,
    grad_accum_steps: int = 1,
    param_labels: Optional[Dict[str, str]] = None,
    precompute_fn: Optional[PrecomputeFn] = None,
    zero1: bool = False,
    fsdp: bool = False,
    sequence_parallel: Optional[bool] = None,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``batch`` leaves are ``[micro, ...]``, or ``[accum, micro, ...]`` when
    ``grad_accum_steps > 1``: the global batch, whose rows each data rank
    of ``mesh`` takes (a :class:`~avsl_tpu_torch.core.mesh.ShardedBatch`
    from ``prefetch_to_device(mesh=...)`` is taken as it is). ``metrics``
    holds device scalars (``loss`` and whatever ``loss_fn`` reports,
    averaged over micro-steps and data ranks, and ``grad_norm``); reading
    one waits for the step. On a mesh, ``zero1`` and ``fsdp`` say how a
    state that is not on it yet is put there.

    ``precompute_fn(batch, generator) -> ctx`` (e.g.
    :func:`~avsl_tpu_torch.train.objectives.flamingo_tower_precompute`)
    runs under ``torch.no_grad()`` on the whole batch, drawing from the
    state's generator before any micro-step; ``ctx[k][i]`` joins
    micro-batch ``i`` (``ctx`` itself without accumulation).
    ``sequence_parallel`` (None: on when the model axis is above 1) splits
    the encoders' activations over T on the model group (see the module
    docstring)."""
    accum = int(grad_accum_steps)
    batch_dim = 1 if accum > 1 else 0

    def pre_fn(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with span("train.precompute"):
            batch, sharded = _prepare(state, mesh, batch, batch_dim, zero1, fsdp)
            rows = None if sharded is None else _rows(mesh, sharded, accum if accum > 1 else 1)
            with torch.no_grad(), row_shard_scope(rows), sp_scope(mesh, sequence_parallel):
                return precompute_fn(batch, state.generator)

    def step_fn(state: TrainState, batch: Dict[str, Any]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        batch, sharded = _prepare(state, mesh, batch, batch_dim, zero1, fsdp)
        model = state.model
        if param_labels is not None:
            for name, p in model.named_parameters():
                p.requires_grad_(param_labels.get(name) == TRAIN)
        rows = None if sharded is None else _rows(mesh, sharded)
        if precompute_fn is not None:
            batch = {**batch, **pre_fn(state, sharded if sharded is not None else batch)}
        micros = [batch] if accum <= 1 else [{k: v[i] for k, v in batch.items()}
                                              for i in range(accum)]
        sums: Dict[str, torch.Tensor] = {}
        with row_shard_scope(rows), sp_scope(mesh, sequence_parallel):
            for micro in micros:
                with span("train.forward"):
                    loss, metrics = loss_fn(micro, state.generator)
                    if rows is not None:
                        loss = loss * _token_scale(rows, micro["labels"])
                with span("train.backward"):
                    loss.backward()
                for key, value in {**metrics, "loss": loss}.items():
                    value = value.detach().float()
                    sums[key] = value if key not in sums else sums[key] + value
        with span("train.optimizer"):
            out = _update(state, sums, len(micros), rows)
        state.step += 1
        return state, out

    def _update(state, sums, n_micros, rows):
        """After the micro-steps: the gradients (reduced over the data
        ranks, averaged over the micro-steps), the metrics, the norm and
        the optimizer's step. Returns the metrics."""
        model, opt = state.model, state.optimizer
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        params = [p for _, p in named]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        layout = state.layout
        if rows is not None and not (layout is not None and layout.fsdp):
            _all_reduce_mean(grads, rows.group, rows.size)
        if accum > 1:
            torch._foreach_div_([local_tensor(g) for g in grads], float(accum))
        out = {key: value / n_micros for key, value in sums.items()}
        if rows is not None:
            stacked = torch.stack([out[k] for k in sorted(out)])
            dist.all_reduce(stacked, group=rows.group)
            out = {k: v / rows.size for k, v in zip(sorted(out), stacked)}
        groups = None if layout is None else [layout.norm_group(n) for n, _ in named]
        out["grad_norm"] = global_norm([local_tensor(g) for g in grads], groups)
        if opt is not None:
            by_param = {id(p): g for p, g in zip(params, grads)}
            opt_grads = [by_param[id(p)] if id(p) in by_param else torch.zeros_like(p)
                         for p in opt.params]
            # the clip's norm is over the trained tensors only; reuse the
            # metric's norm when those are all the tensors with a gradient
            # (MultiSteps drops it and clips on the norm of the mean)
            same = len(opt_grads) == len(grads) and all(id(p) in by_param for p in opt.params)
            opt.step(opt_grads, out["grad_norm"] if same else None)
        for p in params:
            p.grad = None
        return out

    return step_fn


def make_eval_step(loss_fn: LossFn, mesh: Any = None, sequence_parallel: Optional[bool] = None):
    """``eval(state, batch) -> metrics``: the loss without gradients or
    random draws; on a mesh each data rank evaluates its rows (an MoE
    layer routing them as one device routes the global batch) and the
    metrics are the global batch's (the loss its token mean), under
    sequence parallelism as :func:`make_train_step` decides it."""

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch, sharded = _prepare(state, mesh, batch, 0, False, False)
        rows = None if sharded is None else _rows(mesh, sharded)
        with row_shard_scope(rows), sp_scope(mesh, sequence_parallel):
            loss, metrics = loss_fn(batch, None)
        out = {**metrics, "loss": loss}
        if rows is not None:
            out["loss"] = loss * _token_scale(rows, batch["labels"])
            stacked = torch.stack([out[k].float() for k in sorted(out)])
            dist.all_reduce(stacked, group=rows.group)
            out = {k: v / rows.size for k, v in zip(sorted(out), stacked)}
        return out

    return step_fn
