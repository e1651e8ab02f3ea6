"""LoRA: low-rank adapters on the frozen weights of a model.

Port of ``avsl_tpu/models/lora.py``. Each targeted weight ``W`` gets a
trainable delta ``(alpha / rank) * A @ B``; only ``A`` and ``B`` take
gradients and optimizer state, so a train state and its checkpoints are
adapter-sized.

* Targets are regexes over the JAX package's flax parameter paths (the
  default adapts the attention query and value projections,
  ``(q_proj|v_proj)/kernel$``), matched against every 2-D parameter
  through :func:`flax_path`, this port's map from its state-dict keys
  (OpenAI Whisper and fairseq names) to those paths. Adapters are keyed
  by the flax path and kept in JAX's layout: ``lora_a`` [in, r] drawn
  from N(0, 1/r), ``lora_b`` [r, out] zero, so the merged model is the
  base model at step 0. :func:`lora_from_flax` and :func:`lora_to_flax`
  carry a JAX adapter tree in and out.
* :func:`merge_lora` computes the merged weights of the adapted tensors
  only, ``W + ((alpha / r) * A @ B)^T`` (torch keeps [out, in]), in the
  weight's dtype when it is the adapters' (fp32) and through fp32
  otherwise (``lora.py:123-127``). :class:`LoraModel` merges once per
  forward and runs the base model with the merged tensors shadowing its
  weights (an instance attribute over each parameter; the base's own
  tensors never change), which is what autograd differentiates back to
  ``A`` and ``B``. A remat'd block recomputes under the same shadows
  (``models/layers.py::remat_block``).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from avsl_tpu_torch.core.tree import flax_path

DEFAULT_TARGETS: Tuple[str, ...] = (r"(q_proj|v_proj)/kernel$",)

Adapters = Dict[str, Dict[str, torch.Tensor]]

def _two_d(model: nn.Module) -> Dict[str, Tuple[str, nn.Parameter]]:
    """Every 2-D parameter of ``model`` by flax path: (state-dict key, tensor)."""
    return {flax_path(k): (k, p) for k, p in model.named_parameters() if p.ndim == 2}


def target_paths(model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS) -> list:
    """The sorted flax paths of the 2-D parameters that a target regex
    matches (``search``, as JAX's ``init_lora``)."""
    regexes = [re.compile(t) for t in targets]
    return sorted(path for path in _two_d(model) if any(r.search(path) for r in regexes))


def init_lora(generator: torch.Generator, model: nn.Module, rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Adapters:
    """Adapters for every 2-D parameter whose flax path matches a target
    regex, on the parameter's device, in sorted path order: ``lora_a``
    [in, rank] ~ N(0, 1/rank) from ``generator`` and ``lora_b`` [rank,
    out] = 0, both fp32. Raises when nothing matches."""
    weights = _two_d(model)
    paths = target_paths(model, targets)
    if not paths:
        raise ValueError(f"no 2-D params matched LoRA targets {list(targets)!r}")
    out: Adapters = {}
    for path in paths:
        p = weights[path][1]
        d_out, d_in = p.shape
        a = torch.randn((d_in, rank), generator=generator, device=p.device, dtype=torch.float32)
        out[path] = {"lora_a": a / math.sqrt(rank),
                     "lora_b": torch.zeros((rank, d_out), device=p.device, dtype=torch.float32)}
    return out


def iter_adapters(lora: Mapping[str, Mapping[str, torch.Tensor]]
                  ) -> Iterator[Tuple[str, Mapping[str, torch.Tensor]]]:
    """``(flax path, {"lora_a", "lora_b"})`` pairs in sorted path order."""
    for path in sorted(lora):
        yield path, lora[path]


def merge_lora(model: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]], alpha: float,
               rank: int) -> Dict[str, torch.Tensor]:
    """``{state-dict key: W + ((alpha / rank) * A @ B)^T}`` for every adapted
    weight of ``model`` (the others are left out: they are used as they
    are). The sum is in ``W``'s dtype when that is the delta's, else in
    fp32 and cast back, as JAX's. Adapters with no matching weight raise."""
    scale = float(alpha) / float(rank)
    weights = _two_d(model)
    orphans = sorted(set(lora) - set(weights))
    if orphans:
        raise ValueError(f"adapters with no matching base param: {orphans[:4]}")
    merged = {}
    for path, ab in iter_adapters(lora):
        key, w = weights[path]
        delta = (ab["lora_a"] @ ab["lora_b"]) * scale
        if w.dtype == delta.dtype:
            merged[key] = w + delta.t()
        else:
            merged[key] = (w.float() + delta.t()).to(w.dtype)
    return merged


@contextlib.contextmanager
def shadowed(model: nn.Module, tensors: Mapping[str, torch.Tensor]):
    """Within the block, reading the parameter ``key`` of ``model`` (a
    module's ``weight``) gives ``tensors[key]`` instead; the parameters
    themselves, ``parameters()`` and ``state_dict()`` are unchanged."""
    placed = []
    try:
        for key, t in tensors.items():
            owner, _, name = key.rpartition(".")
            module = model.get_submodule(owner)
            if name not in module._parameters:
                raise KeyError(f"{key}: not a parameter of the model")
            module.__dict__[name] = t
            placed.append((module, name))
        yield model
    finally:
        for module, name in placed:
            module.__dict__.pop(name, None)


def lora_from_flax(tree: Mapping[str, Any], device=None) -> Adapters:
    """A JAX adapter tree (nested mappings whose leaves are ``{"lora_a",
    "lora_b"}`` arrays, as ``init_lora`` there builds it) -> fp32 adapters
    by flax path."""
    out: Adapters = {}

    def walk(node, prefix):
        if isinstance(node, Mapping) and set(node) == {"lora_a", "lora_b"}:
            out["/".join(prefix)] = {
                k: torch.as_tensor(np.array(node[k], dtype=np.float32), device=device)
                for k in ("lora_a", "lora_b")}
            return
        for k, v in node.items():
            walk(v, prefix + [str(k)])

    walk(tree, [])
    return out


def lora_to_flax(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """Adapters by flax path -> the nested numpy tree JAX's ``init_lora``
    builds (the inverse of :func:`lora_from_flax`)."""
    nested: Dict[str, Any] = {}
    for path, ab in iter_adapters(lora):
        node = nested
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = {k: ab[k].detach().cpu().numpy() for k in ("lora_a", "lora_b")}
    return nested


def lora_param_count(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    return int(sum(t.numel() for _, ab in iter_adapters(lora) for t in ab.values()))


def lora_summary(model: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]]
                 ) -> Dict[str, Any]:
    """Base and adapter parameter counts, the trainable fraction and the
    adapter count (JAX's ``lora_summary``)."""
    base = int(sum(p.numel() for p in model.parameters()))
    n = lora_param_count(lora)
    return {"base_params": base, "lora_params": n, "trainable_fraction": n / max(base, 1),
            "n_adapters": len(lora)}


_STATS = ("running_mean", "running_var")


class LoraModel(nn.Module):
    """The trainable adapters of a frozen ``base`` model, which this module
    holds without registering it: ``parameters()`` are the adapters
    (``lora_a.<path>``, ``lora_b.<path>``), and ``state_dict()`` is the
    adapters plus the base's BatchNorm statistics (``batch_stats.<key>``),
    what JAX's LoRA train state checkpoints. The base's parameters stop
    taking gradients. Calling it runs the base's forward with the merged
    weights (:meth:`merged`); ``train``/``eval`` switch the base too."""

    def __init__(self, base: nn.Module, lora: Adapters, alpha: float, rank: int):
        super().__init__()
        self.__dict__["base"] = base
        base.requires_grad_(False)
        self.alpha, self.rank = float(alpha), int(rank)
        self.lora_a = nn.ParameterDict({p: nn.Parameter(ab["lora_a"]) for p, ab in lora.items()})
        self.lora_b = nn.ParameterDict({p: nn.Parameter(ab["lora_b"]) for p, ab in lora.items()})
        merge_lora(base, self.adapters(), self.alpha, self.rank)  # orphans raise here

    @property
    def cfg(self):
        return self.base.cfg

    @property
    def device(self) -> torch.device:
        return next(iter(self.lora_a.values())).device

    def adapters(self) -> Adapters:
        """The live adapter tensors by flax path."""
        return {p: {"lora_a": self.lora_a[p], "lora_b": self.lora_b[p]} for p in self.lora_a}

    @torch.no_grad()
    def load_adapters(self, lora: Mapping[str, Mapping[str, torch.Tensor]]) -> "LoraModel":
        """Copy ``lora``'s values (the same paths and shapes) into the adapters."""
        if set(lora) != set(self.lora_a):
            raise ValueError("adapter paths differ from this model's")
        for path, ab in lora.items():
            self.lora_a[path].copy_(ab["lora_a"])
            self.lora_b[path].copy_(ab["lora_b"])
        return self

    def merged_weights(self) -> Dict[str, torch.Tensor]:
        return merge_lora(self.base, self.adapters(), self.alpha, self.rank)

    @contextlib.contextmanager
    def merged(self):
        """Within the block the base model (yielded) computes with the
        merged weights, merged once here."""
        with shadowed(self.base, self.merged_weights()) as base:
            yield base

    def forward(self, *args, **kwargs):
        with self.merged() as base:
            return base(*args, **kwargs)

    def train(self, mode: bool = True) -> "LoraModel":
        super().train(mode)
        self.base.train(mode)
        return self

    def state_dict(self, *args, **kwargs):
        out = super().state_dict(*args, **kwargs)
        for key, buf in self.base.named_buffers():
            if key.endswith(_STATS):
                out[f"batch_stats.{key}"] = buf.detach()
        return out

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        stats = {k[len("batch_stats."):]: v for k, v in state_dict.items()
                 if k.startswith("batch_stats.")}
        own = {k: v for k, v in state_dict.items() if not k.startswith("batch_stats.")}
        result = super().load_state_dict(own, strict=strict)
        buffers = dict(self.base.named_buffers())
        with torch.no_grad():
            for key, value in stats.items():
                buffers[key].copy_(value)
        return result


def lora_loss_fn(base_loss_fn: Callable, lora_model: LoraModel) -> Callable:
    """Wrap a ``loss_fn(batch, generator)`` over the base model so that it
    runs with the merged weights: the gradients reach the adapters only
    (JAX's ``lora_loss_fn``, the base a frozen closure constant)."""

    def wrapped(batch, generator: Optional[torch.Generator]):
        with lora_model.merged():
            return base_loss_fn(batch, generator)

    return wrapped
