"""The shapes of every K1 and K2 launch in a block, read by wrapping the
program's two launch functions (``kernels/attention.py``
``flash_attention_fwd_cuda`` and ``flash_attention_bwd_cuda``). Key
lengths are cloned on the device and read after the block, so the
wrapper adds no host sync; the launches themselves are unchanged."""

from __future__ import annotations

import contextlib
from typing import List


@contextlib.contextmanager
def recorded(on: bool, out: List[dict]):
    if not on:
        yield out
        return
    from avsl_tpu_torch.kernels import attention

    fwd, bwd = attention.flash_attention_fwd_cuda, attention.flash_attention_bwd_cuda

    def note(kind, q, k, lengths, causal):
        b, tq, h, d = q.shape
        out.append({"kind": kind, "b": b, "h": h, "tq": tq, "tk": k.shape[1], "d": d,
                    "itemsize": q.element_size(), "causal": bool(causal),
                    "lengths": None if lengths is None else lengths.detach().clone()})

    def fwd_hook(q, k, v, lengths=None, causal=False, stats=False):
        note("fwd", q, k, lengths, causal)
        return fwd(q, k, v, lengths, causal, stats=stats)

    def bwd_hook(q, k, v, o, do, m, l, lengths=None, causal=False):
        note("bwd", q, k, lengths, causal)
        return bwd(q, k, v, o, do, m, l, lengths, causal)

    attention.flash_attention_fwd_cuda, attention.flash_attention_bwd_cuda = fwd_hook, bwd_hook
    try:
        yield out
    finally:
        attention.flash_attention_fwd_cuda, attention.flash_attention_bwd_cuda = fwd, bwd
    for rec in out:
        if rec["lengths"] is not None:
            rec["lengths"] = [int(x) for x in rec["lengths"].cpu()]
