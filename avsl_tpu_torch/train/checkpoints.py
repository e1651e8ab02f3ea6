"""Step checkpoints of a train state: save with retention, find the
latest, restore in place; weight triage and a params-only restore.

Port of ``save_checkpoint``, ``latest_step``, ``all_steps``,
``restore_checkpoint``, ``partial_load`` and ``restore_params_only`` from
``avsl_tpu/train/checkpoints.py``, with ``torch.save`` files in place of
Orbax directories: one ``step_<N>.pt`` per step under ``directory``,
holding the model's state dict (BatchNorm statistics included), the
optimizer state, the update count and the generator state;
:func:`pin_checkpoint` links a saved step into another directory.
``partial_load`` hands a pretraining state dict's encoder to the
fine-tune heads. Files are read with ``weights_only=True``.

On a mesh (a state with a ``layout``, ``core/partitioning.py``) every rank
calls :func:`save_checkpoint`: the full logical state is gathered to the
CPU and rank 0 writes the one file, in the same format, so
:func:`restore_sharded` puts it into any layout (another data or model
axis, ZeRO-1, FSDP, or no mesh), JAX's resharding on restore.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from avsl_tpu_torch.core.mesh import rank, world_size

_NAME = re.compile(r"^step_(\d+)\.pt$")
# where the fine-tune heads keep the encoder (fairseq's seq2seq nesting)
_W2V = "encoder.w2v_model."


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step)}.pt")


def all_steps(directory: str) -> List[int]:
    """Sorted step numbers saved under ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _map_optimizer_state(state: dict, fn) -> dict:
    """The optimizer state dict (``ClippedAdamW``'s, or ``MultiSteps``'
    around one) with each tensor ``t`` of parameter ``name`` replaced by
    ``fn(name, t, moment)`` (``moment``: an Adam moment, else a gradient
    accumulator)."""
    out = dict(state)
    if "inner" in state:
        out["inner"] = _map_optimizer_state(state["inner"], fn)
        out["acc"] = [fn(n, t, False) for n, t in zip(state["inner"]["names"], state["acc"])]
    else:
        for key in ("mu", "nu"):
            out[key] = [fn(n, t, True) for n, t in zip(state["names"], state[key])]
    return out


def _barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def save_checkpoint(directory: str, state, step: int, max_to_keep: int = 3) -> str:
    """Write ``state`` as step ``step`` (atomically: a temporary file then
    a rename) and keep only the newest ``max_to_keep`` steps. On a mesh
    every rank calls it and rank 0 writes the whole state."""
    layout = getattr(state, "layout", None)
    model_state = (state.model.state_dict() if layout is None
                   else layout.full_model_state(state.model))
    opt_state = None if state.optimizer is None else state.optimizer.state_dict()
    if opt_state is not None and layout is not None:
        opt_state = _map_optimizer_state(
            opt_state, lambda n, t, m: layout.full(n, t, moment=m).cpu())
    path = _path(directory, step)
    if rank() == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({
            "step": int(state.step),
            "model": model_state,
            "optimizer": opt_state,
            "generator": None if state.generator is None else state.generator.get_state(),
        }, tmp)
        os.replace(tmp, path)
        for old in all_steps(directory)[:-max_to_keep]:
            os.remove(_path(directory, old))
    _barrier()
    return path


def pin_checkpoint(src_dir: str, dst_dir: str, step: int, max_to_keep: int = 3) -> str:
    """Put step ``step`` of ``src_dir`` into ``dst_dir`` as a hard link to
    the same file (a copy where the two cannot share it), keeping the
    newest ``max_to_keep`` steps there. The rolling directory replaces and
    removes its files by name, so the pinned step outlives them; a state
    of billions of parameters is not written twice. On a mesh every rank
    calls it and rank 0 links."""
    src, dst = _path(src_dir, step), _path(dst_dir, step)
    if rank() == 0:
        os.makedirs(dst_dir, exist_ok=True)
        tmp = f"{dst}.{os.getpid()}.tmp"
        try:
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
        for old in all_steps(dst_dir)[:-max_to_keep]:
            os.remove(_path(dst_dir, old))
    _barrier()
    return dst


def restore_checkpoint(directory: str, target, step: Optional[int] = None):
    """Load step ``step`` (the latest when None) into ``target`` (a
    matching train state, on a mesh or not) in place, and return it."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"No checkpoint found under {directory}")
    saved = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    layout = getattr(target, "layout", None)
    if layout is None:
        target.model.load_state_dict(saved["model"])
    else:
        layout.load_model_state(target.model, saved["model"])
    if target.optimizer is not None and saved["optimizer"] is not None:
        opt_state = saved["optimizer"]
        if layout is not None:
            opt_state = _map_optimizer_state(
                opt_state, lambda n, t, m: layout.local(n, t, moment=m))
        target.optimizer.load_state_dict(opt_state)
    if target.generator is not None and saved["generator"] is not None:
        target.generator.set_state(saved["generator"])
    target.step = int(saved["step"])
    return target


def restore_sharded(directory: str, target, mesh, rules=None, step: Optional[int] = None,
                    zero1: bool = False, fsdp: bool = False):
    """Load step ``step`` (the latest when None) of ``directory`` into
    ``target`` laid out on ``mesh``: a state not on a mesh yet is put
    there first (``core/partitioning.py::shard_state`` with ``rules``,
    ``zero1`` and ``fsdp``), then each rank copies in its part of every
    tensor. The file holds the logical state, so the writer's layout does
    not matter (``checkpoints.py:79-130`` in JAX). ``mesh`` None restores
    as :func:`restore_checkpoint`."""
    if mesh is not None:
        from avsl_tpu_torch.core.partitioning import DEFAULT_RULES, fsdp_applies, shard_state

        layout = getattr(target, "layout", None)
        if layout is None:
            shard_state(target, mesh, DEFAULT_RULES if rules is None else rules,
                        zero1=zero1, fsdp=fsdp)
        elif layout.mesh is not mesh or layout.fsdp != fsdp_applies(mesh, fsdp):
            raise ValueError("the target is already laid out on another mesh or layout")
    return restore_checkpoint(directory, target, step)


def partial_load(
    model: nn.Module, loaded: Mapping[str, torch.Tensor], strict: bool = False
) -> Tuple[nn.Module, Dict[str, List[str]]]:
    """Copy the entries of ``loaded`` whose key and shape match the model's
    state dict (parameters and buffers) into it, in place. Returns
    ``(model, report)``: ``loaded`` (copied), ``missing`` (in the model,
    not in ``loaded``), ``unexpected`` (in ``loaded`` only) and
    ``shape_mismatch`` keys, the triage the reference logs on its
    non-strict load (``checkpoints.py:138-171``). ``strict`` raises on any
    of the last three.

    A pretraining state dict (fairseq ``AVHubertModel``'s, with
    ``label_embs_concat``) loaded into a model whose encoder sits under
    ``encoder.w2v_model.`` (the fine-tune heads) has its encoder keys
    moved there; ``final_proj`` and ``label_embs_concat`` stay as they are,
    so they come out ``unexpected`` and the head ``missing``."""
    own = model.state_dict()
    if "label_embs_concat" in loaded and "label_embs_concat" not in own and any(
            k.startswith(_W2V) for k in own):
        loaded = {k if k == "label_embs_concat" or k.startswith("final_proj.") else _W2V + k: v
                  for k, v in loaded.items()}
    report: Dict[str, List[str]] = {
        "missing": [k for k in own if k not in loaded],
        "unexpected": [k for k in loaded if k not in own],
        "shape_mismatch": [], "loaded": [],
    }
    with torch.no_grad():
        for key, dst in own.items():
            if key not in loaded:
                continue
            src = torch.as_tensor(loaded[key])
            if tuple(src.shape) != tuple(dst.shape):
                report["shape_mismatch"].append(key)
                continue
            dst.copy_(src)
            report["loaded"].append(key)
    if strict and (report["missing"] or report["unexpected"] or report["shape_mismatch"]):
        raise ValueError(f"Strict load failed: {report}")
    return model, report


def restore_params_only(directory: str, step: Optional[int] = None
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """The model's state dict (parameters and BatchNorm statistics) saved
    at ``step`` (the latest when None) under ``directory``, without the
    optimizer it was trained with; None when the directory holds no
    checkpoint (``checkpoints.py:174-192``)."""
    if latest_step(directory) is None:
        return None
    if step is None:
        step = latest_step(directory)
    return torch.load(_path(directory, step), map_location="cpu", weights_only=True)["model"]
