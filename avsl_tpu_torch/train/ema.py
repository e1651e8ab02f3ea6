"""Parameter EMA and checkpoint averaging ("model soups").

Port of ``avsl_tpu/train/ema.py``:

* :func:`ema_update` — ``ema * decay + new * (1 - decay)`` on the float
  tensors of a name -> tensor mapping, in place, as foreach ops that round
  as the JAX formula does (a product, a product, a sum; not ``lerp``);
  other tensors are taken from ``new``;
* :func:`tree_average` — the uniform mean of identically keyed mappings,
  accumulated in fp32 and cast back to the first mapping's dtype;
* :func:`average_checkpoint_steps` — the uniform average of saved steps
  (the model's state dict: parameters and BatchNorm statistics, JAX's
  ``params`` and ``batch_stats``), with the optimizer, update count and
  generator of the newest contributor; ``python -m
  avsl_tpu_torch.cli.avg_ckpt`` writes it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


def ema_update(ema: Dict[str, torch.Tensor], new: Mapping[str, torch.Tensor],
               decay: float) -> Dict[str, torch.Tensor]:
    """``ema[k] = ema[k] * decay + new[k].to(ema[k].dtype) * (1 - decay)``
    for every floating-point ``ema[k]``, in place; any other entry becomes
    ``new[k]`` (JAX passes int leaves through from ``new``). Returns
    ``ema``."""
    keys = [k for k, e in ema.items() if e.is_floating_point()]
    for k in ema:
        if k not in keys:
            ema[k] = new[k]
    if keys:
        e = [ema[k] for k in keys]
        scaled = torch._foreach_mul([new[k].to(ema[k].dtype) for k in keys], 1.0 - decay)
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, scaled)
    return ema


def tree_average(trees: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The uniform mean over identically keyed mappings: each float tensor
    summed in fp32, divided by the count and cast back to the first
    mapping's dtype; other tensors are the first mapping's."""
    if not trees:
        raise ValueError("nothing to average")
    out: Dict[str, torch.Tensor] = {}
    for key, x0 in trees[0].items():
        if x0.is_floating_point():
            acc = sum(t[key].float() for t in trees)
            out[key] = (acc / len(trees)).to(x0.dtype)
        else:
            out[key] = x0
    return out


def average_checkpoint_steps(directory: str, state_template, steps: Optional[Sequence[int]] = None,
                             last_k: Optional[int] = None) -> Tuple[object, List[int]]:
    """Load ``steps`` (or the newest ``last_k``, or all) saved under
    ``directory`` and return ``(state, used_steps)``: ``state_template``
    restored from the newest contributor (optimizer, update count and
    generator), its model's state dict replaced by the uniform average of
    the contributors' (parameters and BatchNorm statistics), and the
    sorted steps that contributed."""
    from avsl_tpu_torch.train.checkpoints import (
        all_steps,
        restore_checkpoint,
        restore_params_only,
    )

    available = all_steps(directory)
    if not available:
        raise ValueError(f"no checkpoints under {directory!r}")
    if steps is None:
        steps = available[-(last_k or len(available)):]
    missing = sorted(set(steps) - set(available))
    if missing:
        raise ValueError(f"steps {missing} not in {available}")
    used = sorted(steps)
    soup = tree_average([restore_params_only(directory, s) for s in used])
    state = restore_checkpoint(directory, state_template, used[-1])
    state.model.load_state_dict(soup)
    return state, used
