"""Run one cell as ``run.py --trace 1`` does, with the program's span
recorder on inside the traced window, and print after ``run.py``'s line
one more JSON line: ``{"spans": {name: {"value", "unit"}}, "idle_by_span",
"span_count", "thread_spans"}``, the readings of ``hostspans.READINGS``
for the cell's kind of window and the window's idle gaps by the innermost
span open on the window's thread.

Usage, from the root of a checkout, on a machine with the card:

    python3 portbench/spanrun.py --workload <name> --seed <n> --seconds <s>

(``run.py``'s other options pass through.) A program without
``avsl_tpu_torch/utils/spans.py`` records nothing, and every reading is
left out.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from portbench import hostspans, registry, run, trace

    try:
        from avsl_tpu_torch.utils import spans
    except ImportError:
        spans = None
    argv = list(sys.argv[1:] if argv is None else argv)
    got = {}
    reduce, traced, load = trace.reduce, trace.traced, registry.driver

    def reduce_keeping_gaps(events, window_s):
        got["idle"] = hostspans.idle_intervals(events)
        return reduce(events, window_s)

    @contextlib.contextmanager
    def traced_with_spans(on, box):
        got["thread"] = threading.get_ident()
        with traced(on, box), (spans.recording() if spans else contextlib.nullcontext()) as rec:
            yield
        got["trace"], got["record"] = box[0], rec

    def load_keeping_window(kind):
        module = load(kind)
        window = module.window

        def kept(state, seconds):
            got["window"] = win = window(state, seconds)
            return win

        module.window = kept
        return module

    trace.reduce, trace.traced, registry.driver = (reduce_keeping_gaps, traced_with_spans,
                                                    load_keeping_window)
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        trace.reduce, trace.traced, registry.driver = reduce, traced, load
    rec = got.get("record")
    ctx = {"trace": got["trace"], "window": got["window"], "thread": got["thread"],
           "idle": got.get("idle", []), "spans": None if rec is None else rec.spans,
           "counters": None if rec is None else rec.counters}
    line = {"spans": {}, "idle_by_span": None, "span_count": 0, "thread_spans": 0}
    for name, (unit, read) in hostspans.READINGS.items():
        value = read(ctx)
        if value is not None:
            line["spans"][name] = {"value": value, "unit": unit}
    if rec is not None:
        line["span_count"] = len(rec.spans)
        line["thread_spans"] = sum(s.thread == ctx["thread"] for s in rec.spans)
        line["counters"] = rec.counters
        if ctx["trace"] is not None:
            line["idle_by_span"] = hostspans.idle_by_span(ctx["idle"], rec.spans, ctx["thread"])
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
