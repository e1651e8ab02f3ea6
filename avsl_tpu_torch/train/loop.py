"""Train and eval steps: gradient accumulation, clipping and AdamW.

Port of ``avsl_tpu/train/loop.py`` for one device. The JAX step is one jit
program that scans over micro-batches; here it is a Python loop of
forward/backward passes, which is what the scan computes:

* a batch whose leaves carry a leading ``[accum, micro, ...]`` axis runs
  ``accum`` micro-steps; the gradients of each micro-batch's mean loss
  are summed in the parameters' dtype, then divided by ``accum``, and the
  reported metrics are the means over the micro-steps;
* the ``grad_norm`` metric is the global norm of those gradients before
  clipping (the optimizer clips);
* ``param_labels`` (from :func:`avsl_tpu_torch.train.optim.select_optimizer`)
  sets ``requires_grad=False`` on the frozen parameters, so no backward
  runs through frozen-only subgraphs (the JAX step differentiates only the
  trainable subtree);
* random draws (dropout, SpecAugment) come from the state's
  ``torch.Generator``, in order.

``mesh``, ZeRO and FSDP are the parallel layer (ROADMAP.md queue 1, item
12) and raise here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from avsl_tpu_torch.train.optim import TRAIN, ClippedAdamW, global_norm

# loss_fn(batch, generator) -> (loss, metrics dict), over the state's model
LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _parallel_not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option}: the parallel layer is not ported yet (ROADMAP.md queue 1, item 12)"
    )


@dataclass
class TrainState:
    """The model (parameters in place), its optimizer, the update count,
    and the generator every random draw of a step comes from."""

    model: nn.Module
    optimizer: Optional[ClippedAdamW]
    step: int = 0
    generator: Optional[torch.Generator] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optional[ClippedAdamW],
               seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(model=model, optimizer=optimizer, step=0, generator=gen)


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays and tensors -> tensors on ``device`` (integers as
    int64, floats kept)."""
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        out[key] = t.to(device, non_blocking=True)
    return out


def make_train_step(
    loss_fn: LossFn,
    mesh: Any = None,
    grad_accum_steps: int = 1,
    param_labels: Optional[Dict[str, str]] = None,
    precompute_fn: Any = None,
    zero1: bool = False,
    fsdp: bool = False,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``batch`` leaves are ``[micro, ...]``, or ``[accum, micro, ...]`` when
    ``grad_accum_steps > 1``. ``metrics`` holds device scalars (``loss``
    and whatever ``loss_fn`` reports, averaged over micro-steps, and
    ``grad_norm``); reading one waits for the step."""
    if mesh is not None:
        raise _parallel_not_ported("mesh")
    if zero1 or fsdp:
        raise _parallel_not_ported("zero1/fsdp")
    if precompute_fn is not None:
        raise NotImplementedError(
            "precompute_fn: the frozen-tower hoist needs the video slice "
            "(ROADMAP.md queue 1, item 8)"
        )
    accum = int(grad_accum_steps)

    def step_fn(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.model, state.optimizer
        if param_labels is not None:
            for name, p in model.named_parameters():
                p.requires_grad_(param_labels.get(name) == TRAIN)
        device = next(model.parameters()).device
        batch = batch_to_device(batch, device)
        micros = [batch] if accum <= 1 else [{k: v[i] for k, v in batch.items()}
                                              for i in range(accum)]
        sums: Dict[str, torch.Tensor] = {}
        for micro in micros:
            loss, metrics = loss_fn(micro, state.generator)
            loss.backward()
            for key, value in {**metrics, "loss": loss}.items():
                value = value.detach().float()
                sums[key] = value if key not in sums else sums[key] + value
        params = [p for p in model.parameters() if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        out = {key: value / len(micros) for key, value in sums.items()}
        out["grad_norm"] = global_norm(grads)
        if opt is not None:
            by_param = {id(p): g for p, g in zip(params, grads)}
            opt_grads = [by_param[id(p)] if id(p) in by_param else torch.zeros_like(p)
                         for p in opt.params]
            # the clip's norm is over the trained tensors only; reuse the
            # metric's norm when those are all the tensors with a gradient
            same = len(opt_grads) == len(grads) and all(id(p) in by_param for p in opt.params)
            opt.step(opt_grads, out["grad_norm"] if same else None)
        for p in params:
            p.grad = None
        state.step += 1
        return state, out

    return step_fn


def make_eval_step(loss_fn: LossFn, mesh: Any = None):
    """``eval(state, batch) -> metrics``: the loss without gradients or
    random draws."""
    if mesh is not None:
        raise _parallel_not_ported("mesh")

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        device = next(state.model.parameters()).device
        loss, metrics = loss_fn(batch_to_device(batch, device), None)
        return {**metrics, "loss": loss}

    return step_fn
