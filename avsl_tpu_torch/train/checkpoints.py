"""Step checkpoints of a train state: save with retention, find the
latest, restore in place.

Port of ``save_checkpoint``, ``latest_step``, ``all_steps`` and
``restore_checkpoint`` from ``avsl_tpu/train/checkpoints.py``, with
``torch.save`` files in place of Orbax directories: one
``step_<N>.pt`` per step under ``directory``, holding the model's state
dict, the optimizer state, the update count and the generator state.
``partial_load`` (weight triage) and ``restore_sharded`` wait for the
checkpoint-import and parallel items (ROADMAP.md queue 1, items 12-13).
Only files this program wrote are loaded (``torch.load`` unpickles).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


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


def save_checkpoint(directory: str, state, step: int, max_to_keep: int = 3) -> str:
    """Write ``state`` as step ``step`` (atomically: a temporary file then
    a rename) and keep only the newest ``max_to_keep`` steps."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": None if state.optimizer is None else state.optimizer.state_dict(),
        "generator": None if state.generator is None else state.generator.get_state(),
    }, tmp)
    os.replace(tmp, path)
    for old in all_steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return path


def restore_checkpoint(directory: str, target, step: Optional[int] = None):
    """Load step ``step`` (the latest when None) into ``target`` (a
    matching train state) in place, and return it."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"No checkpoint found under {directory}")
    saved = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    target.model.load_state_dict(saved["model"])
    if target.optimizer is not None and saved["optimizer"] is not None:
        target.optimizer.load_state_dict(saved["optimizer"])
    if target.generator is not None and saved["generator"] is not None:
        target.generator.set_state(saved["generator"])
    target.step = int(saved["step"])
    return target
