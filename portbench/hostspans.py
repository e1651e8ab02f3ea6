"""The program's host spans (``avsl_tpu_torch/utils/spans.py``) against
the device trace: which host work the device's idle gaps fall in, and the
span and counter readings of a window.

A reader context here is ``run.py``'s (``trace``, ``window``) with four
more keys: ``spans`` and ``counters``, what a span recording of the traced
window holds (None when the program has no spans); ``thread``, the ident
of the thread that ran the window; and ``idle``, the device's idle gaps
as ``(start ns, end ns)``: the intervals between two busy ones, which
``trace.reduce`` sums by the operation that ends them. Each reading
returns None when it finds nothing to read, as ``readers.py``'s do.

``READINGS`` names the ten readings, by the kind of window they read.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import readers
from portbench.trace import TOP

OUTSIDE = "outside spans"


def idle_intervals(events) -> List[Tuple[int, int]]:
    """The idle gaps of the device's work ``events`` [(name, start ns,
    duration ns)], walked as ``trace.reduce`` walks them: each interval
    from the end of the busy time so far to the start of the next
    operation that starts after it."""
    out, end = [], None
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if end is None:
            end = stop
        elif start > end:
            out.append((end, start))
            end = stop
        elif stop > end:
            end = stop
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_ns(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(spans) -> List[Tuple[float, float, str]]:
    """The time line of one thread's (nested) spans as ``(start, end,
    name of the innermost span open)``, ``OUTSIDE`` where none is, from
    minus to plus infinity."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[int, str]] = []
    t: float = float("-inf")

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                segs.append((t, end, name))
                t = end

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close_until(s.start_ns)
        if s.start_ns > t:
            segs.append((t, s.start_ns, stack[-1][1] if stack else OUTSIDE))
            t = s.start_ns
        stack.append((min(s.end_ns, stack[-1][0]) if stack else s.end_ns, s.name))
    close_until(float("inf"))
    segs.append((t, float("inf"), OUTSIDE))
    return segs


def idle_by_span(idle: Sequence[Tuple[int, int]], spans, thread: int,
                 top: int = TOP) -> List[List]:
    """The idle gaps' seconds grouped by the innermost span open on
    ``thread`` at each instant of a gap (``OUTSIDE`` when none is), the
    ``top`` largest first; a gap across several spans is split between
    them."""
    by: Dict[str, float] = {}
    segs = _innermost([s for s in spans if s.thread == thread])
    j = 0
    for lo, hi in idle:
        while segs[j][1] <= lo:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < hi:
            a, b, name = segs[k]
            part = min(b, hi) - max(a, lo)
            if part > 0:
                by[name] = by.get(name, 0.0) + part / 1e9
            k += 1
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _recorded(ctx, kind):
    win = ctx["window"]
    if win.get("kind") != kind or ctx.get("spans") is None:
        return None
    return win


def _outermost(spans, name: str):
    """The spans ``name`` that lie inside no other span of that name."""
    for s in spans:
        if s.name != name:
            continue
        p = s.parent
        while p >= 0 and spans[p].name != name:
            p = spans[p].parent
        if p < 0:
            yield s


def span_ms(ctx, kind: str, name: str, per: Optional[str] = None) -> Optional[float]:
    """The mean milliseconds of the outermost spans ``name`` of the window
    (any thread); with ``per`` (a count the window reports, such as
    ``updates``), their total over it."""
    win = _recorded(ctx, kind)
    if win is None:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in _outermost(ctx["spans"], name)]
    if per is not None:
        return sum(ms) / win[per] if win.get(per) else None
    return sum(ms) / len(ms) if ms else None


def idle_in(ctx, kind: str, names: Sequence[str]) -> Optional[float]:
    """100 x the device's idle time inside the spans ``names`` of the
    window's thread (their union, intersected with the idle gaps) over the
    traced window."""
    tr = ctx["trace"]
    if _recorded(ctx, kind) is None or readers._window(ctx, kind) is None or tr.window_s <= 0:
        return None
    mine = _union((s.start_ns, s.end_ns) for s in ctx["spans"]
                  if s.thread == ctx["thread"] and s.name in names)
    return 100.0 * _overlap_ns(ctx["idle"], mine) / 1e9 / tr.window_s


def counter_per(ctx, kind: str, counter: str, unit: str, scale: float = 1.0) -> Optional[float]:
    """``scale`` x the counter over the window's ``unit`` (such as
    ``segments``)."""
    win = _recorded(ctx, kind)
    if win is None or counter not in ctx["counters"] or not win.get(unit):
        return None
    return scale * ctx["counters"][counter] / win[unit]


SERVE_DATA = ("serve.queue_wait", "serve.upload")
DECODE = ("decode.prefill", "decode.step", "decode.sync")
TRAIN_DATA = ("data.batch", "data.wait", "train.upload")
TRAIN_STEP = ("train.precompute", "train.forward", "train.backward", "train.optimizer")

# name -> (unit, reading); the layer each reads is PERF.md §3's
READINGS = {
    "host_prepare_ms.transcribe": ("ms", lambda c: span_ms(c, "transcribe", "serve.prepare")),
    "idle_in_data.transcribe": ("%", lambda c: idle_in(c, "transcribe", SERVE_DATA)),
    "upload_mb_per_seg.transcribe": (
        "MB/seg", lambda c: counter_per(c, "transcribe", "h2d_bytes", "segments", 1e-6)),
    "decode_step_ms.transcribe": ("ms", lambda c: span_ms(c, "transcribe", "decode.step")),
    "idle_in_decode.transcribe": ("%", lambda c: idle_in(c, "transcribe", DECODE)),
    "host_collate_ms.train": ("ms", lambda c: span_ms(c, "train", "data.batch")),
    "idle_in_data.train": ("%", lambda c: idle_in(c, "train", TRAIN_DATA)),
    "upload_mb_per_seg.train": (
        "MB/seg", lambda c: counter_per(c, "train", "h2d_bytes", "segments", 1e-6)),
    "optimizer_ms.train": ("ms", lambda c: span_ms(c, "train", "train.optimizer", "updates")),
    "idle_in_step.train": ("%", lambda c: idle_in(c, "train", TRAIN_STEP)),
}
