"""Optimizers: AdamW with global-norm clipping and linear warmup/decay,
and the per-regime parameter freezing.

Port of ``avsl_tpu/train/optim.py``. The JAX package builds
``optax.multi_transform`` over path labels with ``set_to_zero`` for the
frozen group; here :func:`label_params` labels the model's named
parameters (OpenAI names joined with "."), and :class:`ClippedAdamW` holds
state for, and updates, only the TRAIN ones. It mirrors the optax chain
``clip_by_global_norm(clip_norm)`` then ``adamw(schedule)`` exactly:

* the global norm has no epsilon (unlike ``clip_grad_norm_``'s 1e-6):
  gradients pass unchanged when the norm is below ``clip_norm``, else
  become ``(g / norm) * clip_norm``;
* Adam moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``
  with bias correction, and eps outside the square root;
* weight decay on every trained tensor, scaled like the Adam term by the
  scheduled learning rate: ``p -= lr_t (mu_hat / (sqrt(nu_hat) + eps) +
  wd p)``;
* the schedule is read at the update count before the increment, so the
  first update has learning rate ``schedule(0) = 0``.

:class:`MultiSteps` is ``optax.MultiSteps(tx, every_k_schedule=k)`` around
it, the JAX CLI's accumulation across bucketed batches of varying size.
:func:`lora_optimizer` is the LoRA regime's (every adapter trains, no
weight decay) and :func:`constant_adamw` is ``optax.adamw(lr,
weight_decay=wd)``, which draft distillation uses: the same class with a
constant schedule and no clip. :func:`warmup_cosine_decay` is optax's
``warmup_cosine_decay_schedule``, which the landmark CNN trains on.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from avsl_tpu_torch.core.partitioning import local_tensor

TRAIN = "train"
FROZEN = "frozen"

# parameter-name patterns (regex, searched in the "."-joined name)
VIDEO_MODEL_PATTERNS = (r"video_model", r"visual_encoder")
VIDEO_PROJECTION_PATTERNS = (r"video_projection",)
GATED_X_ATTN_PATTERNS = (r"x_attn", r"x_mlp")

Schedule = Callable[[int], float]
# elements per chunk of the update, which bounds its temporaries
_CHUNK_ELEMENTS = 1 << 27


def label_params(
    model: nn.Module, trainable_patterns: Sequence[str], frozen_patterns: Sequence[str] = ()
) -> Dict[str, str]:
    """Label each named parameter TRAIN or FROZEN. A parameter trains iff
    it matches a trainable pattern and no frozen pattern (frozen wins)."""
    t_res = [re.compile(p) for p in trainable_patterns]
    f_res = [re.compile(p) for p in frozen_patterns]

    def label(name: str) -> str:
        if any(r.search(name) for r in f_res):
            return FROZEN
        return TRAIN if any(r.search(name) for r in t_res) else FROZEN

    return {name: label(name) for name, _ in model.named_parameters()}


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup from 0 to ``lr`` over ``max(warmup_steps, 1)``
    updates, then linear decay to 0 at ``total_steps`` (optax
    ``join_schedules`` of two ``linear_schedule``s, in fp32)."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    def schedule(count: int) -> float:
        if count < warm:
            return linear(0.0, lr, warm, count)
        return linear(lr, 0.0, decay, count - warm)

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int) -> Schedule:
    """optax ``warmup_cosine_decay_schedule`` (end value 0, exponent 1) in
    fp32: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps`` updates, then a cosine from ``peak_value`` to 0 over
    ``decay_steps - warmup_steps`` (0 after). Raises ValueError, as optax
    does, unless ``decay_steps > warmup_steps``."""
    steps = decay_steps - warmup_steps
    if not steps > 0:
        raise ValueError(f"warmup_cosine_decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps=} and {warmup_steps=}")
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax polynomial_schedule, power 1
            frac = f32(1.0) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(steps)))
        return float(f32(peak_value) * cosine)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor],
                groups: Optional[Sequence[Tuple[Any, Any]]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over all ``tensors``, fp32, on their
    device (no host sync). ``groups`` gives, for each tensor that is a
    part of a larger one, the (data, model) process groups its other parts
    live on (None where it is whole along that axis): the squared sums
    are then added over those groups, so every rank gets the norm of the
    whole."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    if groups is None or all(g == (None, None) for g in groups):
        return torch.linalg.vector_norm(torch.stack(norms))
    buckets: Dict[Tuple[Any, Any], List[torch.Tensor]] = {}
    for n, g in zip(norms, groups):
        buckets.setdefault(g, []).append(n)
    total = None
    for (data, model), part in buckets.items():
        sq = torch.stack(part).square().sum()
        for group in (data, model):
            if group is not None:
                dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return total.sqrt()


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over the TRAIN parameters.

    ``params`` are the trained tensors (updated in place by :meth:`step`);
    their moments are fp32 (or the parameter dtype) tensors on their
    device. Frozen parameters get neither state nor updates
    (``set_to_zero``). On a mesh (:meth:`bind`, from
    ``core/partitioning.py::shard_state``) each rank updates its own part
    of every tensor (a DTensor's local shard under FSDP, its columns or
    rows under tensor parallelism, its ZeRO-1 slice, whose parameter is
    then all-gathered over the data ranks) and the clip reads the norm of
    the whole gradient."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        schedule: Schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.01,
        clip_norm: float = 1.0,
    ):
        self.names: List[str] = list(params)
        self.params: List[torch.Tensor] = [params[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.layout = None

    def bind(self, params: Dict[str, torch.Tensor], layout) -> None:
        """Take the parameters ``params`` (by name, as ``shard_state``
        left them) and cut the moments to ``layout``."""
        self.params = [params[n] for n in self.names]
        with torch.no_grad():
            self.mu = [layout.local(n, m, moment=True).clone() for n, m in zip(self.names, self.mu)]
            self.nu = [layout.local(n, m, moment=True).clone() for n, m in zip(self.names, self.nu)]
        self.layout = layout

    def norm_groups(self) -> Optional[List[Tuple[Any, Any]]]:
        """For :func:`global_norm`: where the other parts of each
        gradient live (None off a mesh)."""
        if self.layout is None:
            return None
        return [self.layout.norm_group(n) for n in self.names]

    def learning_rate(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def _zero_slice(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This data rank's ZeRO-1 slice of tensor ``i`` (``t`` itself when
        its moments are whole)."""
        name = self.names[i]
        if self.layout is None or name not in self.layout.zero:
            return t
        d, n = self.layout.zero[name], self.layout.dp
        size = t.shape[d] // n
        return t.narrow(d, self.layout.mesh.data_rank * size, size)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (aligned with :attr:`params`; they are
        overwritten). ``grad_norm`` is their global norm when the caller
        already has it."""
        grads = [local_tensor(g) for g in grads]
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if not grads:
            self.count += 1
            return
        norm = global_norm(grads, self.norm_groups()) if grad_norm is None else grad_norm
        # (g / norm) * clip_norm when norm >= clip_norm, else g unchanged
        below = norm < self.clip_norm
        divisor = torch.where(below, torch.ones_like(norm), norm)
        factor = torch.where(below, torch.ones_like(norm), torch.full_like(norm, self.clip_norm))
        count = self.count + 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        lr = self.schedule(self.count)
        params = [self._zero_slice(i, local_tensor(p)) for i, p in enumerate(self.params)]
        grads = [self._zero_slice(i, g) for i, g in enumerate(grads)]
        for lo, hi in self._chunks():
            g, p = grads[lo:hi], params[lo:hi]
            mu, nu = self.mu[lo:hi], self.nu[lo:hi]
            torch._foreach_div_(g, divisor.to(g[0].device))
            torch._foreach_mul_(g, factor.to(g[0].device))
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(p, upd)
        if self.layout is not None and self.layout.zero:
            self._gather_zero()
        self.count = count

    def _gather_zero(self) -> None:
        """All-gather each ZeRO-1 parameter's updated slices over the data
        ranks (one collective per tensor)."""
        layout = self.layout
        for name, p in zip(self.names, self.params):
            if name in layout.zero:
                d = layout.zero[name]
                full = local_tensor(p)
                size = full.shape[d] // layout.dp
                part = full.narrow(d, layout.mesh.data_rank * size, size).contiguous()
                parts = [torch.empty_like(part) for _ in range(layout.dp)]
                dist.all_gather(parts, part, group=layout.mesh.data_group)
                full.copy_(torch.cat(parts, d))

    def _chunks(self):
        lo, size = 0, 0
        for i, p in enumerate(self.params):
            size += p.numel()
            if size >= _CHUNK_ELEMENTS:
                yield lo, i + 1
                lo, size = i + 1, 0
        if lo < len(self.params):
            yield lo, len(self.params)

    def state_dict(self) -> dict:
        return {"count": self.count, "names": list(self.names),
                "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state was saved for other parameters")
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)
        self.count = int(state["count"])


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)`` over a
    :class:`ClippedAdamW`: accumulate ``every_k`` successive gradients and
    update once with their mean.

    The mean is optax's running one, ``acc += (g - acc) / (mini_step + 1)``
    in fp32 (one in-place lerp), so each micro-batch weighs the same
    whatever its size. The
    inner optimizer steps only on the ``every_k``-th call, with the mean:
    its clip takes the norm of the mean, and its schedule and bias
    correction advance once per update. The parameters do not move on the
    other calls. The accumulators are buffers of this object, one per
    trained tensor (frozen tensors, whose updates are zero, get none), and
    carry across epochs; :meth:`state_dict` holds them with the mini-step,
    so a run saved mid-accumulation resumes to the same parameters."""

    def __init__(self, inner: ClippedAdamW, every_k: int):
        if int(every_k) < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.names, self.params = inner.names, inner.params
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    def bind(self, params: Dict[str, torch.Tensor], layout) -> None:
        """:meth:`ClippedAdamW.bind`, the accumulators cut like the
        gradients."""
        self.inner.bind(params, layout)
        self.params = self.inner.params
        with torch.no_grad():
            self.acc = [layout.local(n, a).clone() for n, a in zip(self.names, self.acc)]

    def norm_groups(self):
        return self.inner.norm_groups()

    @property
    def count(self) -> int:
        """Updates of the inner optimizer so far."""
        return self.inner.count

    def learning_rate(self) -> float:
        """The learning rate of the next update."""
        return self.inner.learning_rate()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> bool:
        """Fold one micro-batch's ``grads`` (aligned with :attr:`params`,
        left untouched) into the mean; on the ``every_k``-th call update
        the parameters with it and reset. Returns whether it updated.
        ``grad_norm``, the micro-batch's norm, is taken as
        :meth:`ClippedAdamW.step` takes it and dropped: the clip uses the
        norm of the mean."""
        del grad_norm
        grads = [local_tensor(g) for g in grads]
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.acc:
            torch._foreach_lerp_(self.acc, grads, 1.0 / (self.mini_step + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        self.inner.step(self.acc)  # clips (in place) on the norm of the mean
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "every_k": self.every_k,
                "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        if int(state["every_k"]) != self.every_k:
            raise ValueError(f"state accumulates every {state['every_k']} steps, "
                             f"not {self.every_k}")
        self.inner.load_state_dict(state["inner"])
        with torch.no_grad():
            for dst, src in zip(self.acc, state["acc"]):
                dst.copy_(src)
        self.mini_step = int(state["mini_step"])


def _adamw(model: nn.Module, labels: Dict[str, str], cfg, t_total: int) -> ClippedAdamW:
    sched = linear_warmup_decay(float(cfg.learning_rate), int(cfg.warmup_steps), int(t_total))
    params = {n: p for n, p in model.named_parameters() if labels[n] == TRAIN}
    return ClippedAdamW(
        params, sched,
        b1=0.9,
        b2=float(getattr(cfg, "adam_beta2", 0.999)),
        eps=float(getattr(cfg, "adam_epsilon", 1e-8)),
        weight_decay=float(getattr(cfg, "weight_decay", 0.01)),
        clip_norm=float(getattr(cfg, "clip_norm", 1.0) or 1.0),
    )


def whisper_optimizer(model: nn.Module, cfg, t_total: int) -> Tuple[ClippedAdamW, Dict[str, str]]:
    """All-parameter AdamW (optionally still freezing the video model)."""
    frozen = VIDEO_MODEL_PATTERNS if getattr(cfg, "freeze_video_model", False) else ()
    labels = label_params(model, trainable_patterns=(r".*",), frozen_patterns=frozen)
    return _adamw(model, labels, cfg, t_total), labels


def whisper_video_projection_optimizer(model: nn.Module, cfg, t_total: int):
    """Train only the video projection (video_projection_train_only)."""
    labels = label_params(model, trainable_patterns=VIDEO_PROJECTION_PATTERNS)
    return _adamw(model, labels, cfg, t_total), labels


def whisper_flamingo_projection_optimizer(model: nn.Module, cfg, t_total: int):
    """Train gated x-attn sublayers + video projection; freeze the rest
    (including the AV-HuBERT video model)."""
    labels = label_params(
        model,
        trainable_patterns=GATED_X_ATTN_PATTERNS + VIDEO_PROJECTION_PATTERNS,
        frozen_patterns=VIDEO_MODEL_PATTERNS,
    )
    return _adamw(model, labels, cfg, t_total), labels


def lora_optimizer(lora_model: nn.Module, cfg, t_total: int) -> Tuple[ClippedAdamW, Dict[str, str]]:
    """The LoRA regime (``models/lora.py``): clip, then AdamW over the
    adapters, every one of which trains, with weight decay 0 (decaying A
    and B decays the delta) and the linear warmup/decay schedule; the base
    is not among the parameters at all."""
    sched = linear_warmup_decay(float(cfg.learning_rate), int(cfg.warmup_steps), int(t_total))
    params = dict(lora_model.named_parameters())
    opt = ClippedAdamW(
        params, sched, b1=0.9,
        b2=float(getattr(cfg, "adam_beta2", 0.999)),
        eps=float(getattr(cfg, "adam_epsilon", 1e-8)),
        weight_decay=0.0,
        clip_norm=float(getattr(cfg, "clip_norm", 1.0) or 1.0),
    )
    return opt, {name: TRAIN for name in params}


def constant_adamw(params: Dict[str, torch.Tensor], lr: float,
                   weight_decay: float = 0.01) -> ClippedAdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)``: a constant learning
    rate, no clip (an infinite ``clip_norm`` leaves every finite gradient
    as it is: divided and multiplied by 1), decay on every tensor in
    ``params``."""
    return ClippedAdamW(params, lambda count: float(lr), weight_decay=weight_decay,
                        clip_norm=math.inf)


def select_optimizer(model: nn.Module, cfg, t_total: int):
    """Regime selection mirroring the reference's configure_optimizers.
    The two Flamingo regimes label correctly here but need the video slice
    (ROADMAP.md queue 1, items 6-8) to have anything to train."""
    if getattr(cfg, "add_gated_x_attn", 0):
        return whisper_flamingo_projection_optimizer(model, cfg, t_total)
    if getattr(cfg, "video_projection_train_only", False):
        return whisper_video_projection_optimizer(model, cfg, t_total)
    return whisper_optimizer(model, cfg, t_total)

