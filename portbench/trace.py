"""The traced window: ``torch.profiler`` with device activity only, and
its reduction to busy time, launches, the time of named kernels, the
device operations that took longest and the longest idle gaps.

Busy time is the union of the intervals of every kernel, copy and set on
the device, so work on overlapping streams counts once. An idle gap is
an interval between two busy ones; gaps are grouped by the operation
that ends them, which is what the host was getting ready to issue. Host
events are not recorded: they would slow the host-paced loops this
measures.
"""

from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


def short(name: str) -> str:
    """A kernel's name without namespaces in parentheses, template
    arguments, parameters and a leading return type."""
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    name = re.sub(r"\(.*$", "", "".join(out)).strip()
    name = re.sub(r"^void ", "", name)
    return name[-120:] if name else "unnamed"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    copies: int
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)

    def seconds_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, (s, _) in self.by_name.items() if rx.search(name))

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [["before " + n, s] for n, s in gaps]}


def reduce(events, window_s: float) -> Trace:
    """``events``: (name, start ns, duration ns) of the device's work."""
    events = sorted(events, key=lambda e: e[1])
    by_name: Dict[str, Tuple[float, int]] = {}
    gaps: Dict[str, float] = {}
    busy_ns, kernels, copies = 0, 0, 0
    end: Optional[int] = None
    for name, start, dur in events:
        label = short(name)
        s, n = by_name.get(label, (0.0, 0))
        by_name[label] = (s + dur / 1e9, n + 1)
        if name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
        stop = start + dur
        if end is None:
            busy_ns += dur
            end = stop
        elif start > end:
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e9
            busy_ns += dur
            end = stop
        elif stop > end:
            busy_ns += stop - end
            end = stop
    return Trace(window_s, busy_ns / 1e9, kernels, copies, by_name, gaps)


@contextlib.contextmanager
def traced(on: bool, box: list):
    """Within the block the device's work is profiled when ``on``; on exit
    (after a synchronize) ``box`` receives the :class:`Trace`, or None
    when ``on`` is false."""
    if not on:
        yield
        box.append(None)
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    box.append(reduce(events, window))
