"""``hostspans.py``'s readings of the program's spans against the device
trace, held to hand-worked values on a synthetic trace, and the gaps it
splits between spans against those ``trace.reduce`` sums."""

import numpy as np
import pytest

from avsl_tpu_torch.utils import spans
from portbench import hostspans, readers, trace

MS = 1_000_000  # ns

# device work (ns): busy 0-10, 20-40 (two overlapping), 50-60 ms; idle gaps
# 10-20 (before B) and 40-50 (before D)
EVENTS = [("A", 0, 10 * MS), ("B", 20 * MS, 10 * MS), ("C", 25 * MS, 15 * MS),
          ("D", 50 * MS, 10 * MS)]
WINDOW_S = 0.1


def _synthetic(thread=1, other=2):
    S = spans.Span
    recorded = [S("serve.batch", thread, 5 * MS, 45 * MS, -1),
                S("decode.step", thread, 12 * MS, 18 * MS, 0),
                S("decode.sync", thread, 18 * MS, 22 * MS, 0),
                S("serve.prepare", other, 0, 100 * MS, -1),
                S("serve.prepare", other, 10 * MS, 20 * MS, 3),
                S("serve.upload", thread, 46 * MS, 48 * MS, -1)]
    tr = trace.reduce(EVENTS, WINDOW_S)
    win = {"kind": "transcribe", "segments": 4, "updates": 2}
    ctx = {"trace": tr, "window": win, "spans": recorded, "counters": {"h2d_bytes": 8_384_000},
           "thread": thread, "idle": hostspans.idle_intervals(EVENTS)}
    return ctx


def test_portbench_span_readings_by_hand():
    ctx = _synthetic()
    tr = ctx["trace"]
    assert ctx["idle"] == [(10 * MS, 20 * MS), (40 * MS, 50 * MS)]
    assert sum(b - a for a, b in ctx["idle"]) / 1e9 == pytest.approx(sum(tr.gaps.values()))
    # the idle 10-20 ms: 2 in serve.batch, 6 in decode.step, 2 in
    # decode.sync; 40-50 ms: 5 in serve.batch, 1 outside, 2 in serve.upload,
    # 2 outside
    by = dict(hostspans.idle_by_span(ctx["idle"], ctx["spans"], ctx["thread"]))
    assert by == pytest.approx({"serve.batch": 0.007, "decode.step": 0.006,
                                hostspans.OUTSIDE: 0.003, "decode.sync": 0.002,
                                "serve.upload": 0.002})
    assert sum(by.values()) == pytest.approx(sum(tr.gaps.values()))
    assert hostspans.idle_in(ctx, "transcribe", hostspans.DECODE) == pytest.approx(8.0)
    assert hostspans.idle_in(ctx, "transcribe", hostspans.SERVE_DATA) == pytest.approx(2.0)
    assert hostspans.idle_in(ctx, "transcribe", ("serve.batch",)) == pytest.approx(15.0)
    # the inner serve.prepare lies in an outer one: one span of 100 ms
    assert hostspans.span_ms(ctx, "transcribe", "serve.prepare") == pytest.approx(100.0)
    assert hostspans.span_ms(ctx, "transcribe", "decode.step") == pytest.approx(6.0)
    assert hostspans.span_ms(ctx, "transcribe", "decode.sync", per="updates") == \
        pytest.approx(2.0)
    assert hostspans.counter_per(ctx, "transcribe", "h2d_bytes", "segments", 1e-6) == \
        pytest.approx(2.096)
    read = {name: r(ctx) for name, (_, r) in hostspans.READINGS.items()}
    assert read["upload_mb_per_seg.transcribe"] == pytest.approx(2.096)
    assert read["idle_in_data.transcribe"] + read["idle_in_decode.transcribe"] <= \
        readers.idle_share(ctx, "transcribe") + 0.1
    # the other kind of window, and a program without spans, read nothing
    assert all(v is None for k, v in read.items() if k.endswith(".train"))
    assert all(r({**ctx, "spans": None, "counters": None}) is None
               for _, r in hostspans.READINGS.values())


def test_portbench_idle_by_span_covers_every_gap():
    """On a long random trace and nested spans, the gaps split between the
    spans add up to every gap the trace reduction sums, and the existing
    readings do not depend on the spans."""
    rng = np.random.default_rng(5)
    starts = np.cumsum(rng.integers(1, 40, 400)) * 1000
    events = [(f"k{i % 7}", int(s), int(d)) for i, (s, d) in
              enumerate(zip(starts, rng.integers(1, 60, 400) * 1000))]
    tr = trace.reduce(events, 20.0)
    idle = hostspans.idle_intervals(events)
    S = spans.Span
    recorded, t = [], 0
    while t < int(starts[-1]):
        a = t + int(rng.integers(0, 50_000))
        b = a + int(rng.integers(1, 200_000))
        recorded.append(S("outer", 1, a, b, -1))
        recorded.append(S(f"inner{len(recorded) % 3}", 1, a + (b - a) // 3, b - (b - a) // 3,
                          len(recorded) - 1))
        t = b
    split = hostspans.idle_by_span(idle, recorded, 1, top=100)
    assert sum(s for _, s in split) == pytest.approx(sum(tr.gaps.values()), rel=1e-9)
    ctx = {"trace": tr, "window": {"kind": "train", "segments": 10}, "launches": [],
           "spans": recorded, "counters": {}, "thread": 1, "idle": idle}
    bare = {"trace": trace.reduce(events, 20.0), "window": ctx["window"], "launches": []}
    assert readers.idle_share(ctx, "train") == readers.idle_share(bare, "train")
    assert readers.launches_per(ctx, "train", "segments") == \
        readers.launches_per(bare, "train", "segments")
    assert tr.breakdown() == bare["trace"].breakdown()
    inside = hostspans.idle_in(ctx, "train", ("outer",))
    assert 0 < inside <= readers.idle_share(ctx, "train")
