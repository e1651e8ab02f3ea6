"""Tensors a forward reports beside its output, for the loss to read.

The port's counterpart of flax's ``sow`` into the ``"intermediates"``
collection (``model.apply(..., mutable=["intermediates"])``): a loss opens
:func:`collect_intermediates` around its forward, and the modules inside
call :func:`sow` (the MoE FFN its Switch balance loss ``"moe_aux"``, the
AV-HuBERT encoder its pre-norm fused features ``"extracted_features"``).
Nothing is kept on a module: with no collector open, ``sow`` drops the
value, and the collector belongs to the thread that opened it. A remat
recompute (:func:`~avsl_tpu_torch.models.layers.remat_block`) sows
nothing, so a loss reads each value of the first forward once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List

import torch

from avsl_tpu_torch.models.layers import recomputing

Intermediates = Dict[str, List[torch.Tensor]]

_LOCAL = threading.local()


@contextlib.contextmanager
def collect_intermediates() -> Iterator[Intermediates]:
    """Within the block, what the forward sows, by name, in sowing order."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    store: Intermediates = {}
    stack.append(store)
    try:
        yield store
    finally:
        stack.pop()


def sow(name: str, value: torch.Tensor) -> None:
    """Append ``value`` under ``name`` to the innermost open collector of
    this thread; nothing when none is open or a remat recompute runs."""
    stack = getattr(_LOCAL, "stack", None)
    if stack and not recomputing():
        stack[-1].setdefault(name, []).append(value)
