"""What the training drivers read from the program's own optimizer, and
their timed loop.

The first clipped gradient is worked out from Adam's state after one
update: its first moment is ``(1 - b1) g``. The change is each trained
tensor after the last checked update less its copy on the host from
before the first."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import torch


def host_copy(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [p.detach().to("cpu", copy=True) for p in params]


def grad_norms(names: Sequence[str], adam) -> Dict[str, float]:
    """Each tensor's norm of the clipped gradient of the first update,
    from the first moment of a ``ClippedAdamW`` that has updated once."""
    norms = torch.stack(torch._foreach_norm(adam.mu)) / (1.0 - adam.b1)
    return dict(zip(names, norms.tolist()))


def change_norms(names: Sequence[str], params: Sequence[torch.Tensor],
                 start: Sequence[torch.Tensor]) -> Dict[str, float]:
    with torch.no_grad():
        norms = torch.stack([(p.detach() - s.to(p.device)).norm() for p, s in zip(params, start)])
    return dict(zip(names, norms.tolist()))


def failed_rows(steps: Sequence[tuple]) -> int:
    """Rows of the window's steps ``[(loss, rows)]`` whose loss is not
    finite, read once the window has closed (no sync inside it)."""
    if not steps:
        return 0
    finite = torch.isfinite(torch.stack([torch.as_tensor(l).float().reshape(()) for l, _ in steps]))
    return sum(rows for (_, rows), ok in zip(steps, finite.tolist()) if not ok)


def timed(step: Callable[[], tuple], seconds: float, cuda: bool) -> Dict[str, float]:
    """Call ``step() -> (segments, updated)`` until an update completes
    after ``seconds``: the segments of the completed updates and their
    seconds (the device synchronised at each update), and when each
    update ended."""
    t0 = time.perf_counter()
    segments = pending = updates = 0
    ends = []
    while True:
        rows, updated = step()
        pending += rows
        if updated:
            if cuda:
                torch.cuda.synchronize()
            segments, pending, updates = segments + pending, 0, updates + 1
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds:
                return {"segments": segments, "updates": updates, "seconds": elapsed,
                        "ends_s": ends}
