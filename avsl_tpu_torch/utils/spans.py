"""Host spans and counters of the port, on the device trace's clock.

A span names one stretch of host work where it happens::

    with span("decode.step"):
        ...

While a :func:`recording` block is open, each span records its name, the
ident of the thread that ran it, its start and end from ``time.time_ns()``
(Unix-epoch nanoseconds, the clock ``torch.profiler`` stamps its events
with, so spans and device activity share one time line), the index in
``Record.spans`` of the innermost span open on the same thread (-1 for
none). :func:`count`
adds to a named counter (``h2d_bytes``: the bytes of host arrays an upload
site moves to the model's device).

Outside a recording block :func:`span` returns one shared no-op object and
:func:`count` returns at once: neither reads a clock, allocates or takes a
lock. On or off, the recorder only reads the host clock: it never
synchronises the device, touches a tensor or draws a random number, so no
span changes a result or the order of the program's random draws.

The span names, by layer (the thread is the caller's unless named):

* serving (``infer/pipeline.py``, ``decode/greedy.py``): ``serve.prepare``
  (the producer thread's host preparation of a batch),
  ``serve.queue_wait`` (the consumer's wait for it), ``serve.batch`` (one
  batch's device half), ``serve.upload``,
  ``serve.encode`` (log-mel and the encoders), ``serve.cache``,
  ``decode.prefill`` (the prompt step and first pick), ``decode.step``
  (each later step), ``decode.sync`` (the host's read of whether every row
  has finished), ``serve.readback``, ``serve.results`` (detokenising);
* training data (``data/runtime.py``, ``data/prefetch.py``, the CLIs'
  batch makers): ``data.batch`` (dataset reads and collation of one
  batch), ``data.wait`` (the consumer's wait on the prefetch queue);
* the train step (``train/loop.py``): ``train.step``, ``train.upload``,
  ``train.precompute`` (the frozen-tower hoist), ``train.forward`` and ``train.backward`` (each micro-step),
  ``train.optimizer`` (gradient collection, any all-reduce, the norm and
  the optimizer's step);
* Auto-AVSR's forward (``models/conformer.py``, inside ``train.forward``):
  ``avsr.frontend`` (both ResNets), ``avsr.conformer`` (both embeddings
  and Conformer stacks) and ``avsr.head`` (the fusion, the CTC head, the
  decoder and the joint loss, ``train/objectives.py``), and the counter
  ``avsr.relpos_bytes`` (the bytes of the relative-position score tensors
  a forward materialises);
* AV-HuBERT's positional conv (``models/avhubert.py``, inside
  ``train.backward``): the counter ``avhubert.pos_conv_input_grad`` (one
  per input gradient computed as a forward-direction conv).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: int


@dataclass
class Record:
    """What one :func:`recording` block collected: ``spans`` in the order
    they were entered (a span still open when the block ended is cut at
    its end) and ``counters`` by name."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _open: bool = True


class _Off:
    """The span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_record: Optional[Record] = None
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _On:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = _stack()
        # a span left open by an earlier recording is no parent here
        rec, parent = stack[-1] if stack else (None, -1)
        if rec is not self.rec:
            parent = -1
        start = time.time_ns()
        with self.rec._lock:
            # entered after its recording ended (on a thread that outlived
            # the block): nothing to record
            self.index = len(self.rec.spans) if self.rec._open else -1
            if self.index >= 0:
                self.rec.spans.append(Span(self.name, threading.get_ident(), start, -1, parent))
        stack.append((self.rec, self.index))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        rec = self.rec
        with rec._lock:
            if rec._open and self.index >= 0:
                rec.spans[self.index] = rec.spans[self.index]._replace(end_ns=end)
        return False


def span(name: str):
    """A context manager that records ``name`` over its block while a
    :func:`recording` is open; otherwise one shared object that does
    nothing."""
    rec = _record
    if rec is None:
        return _OFF
    return _On(rec, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a :func:`recording` is open."""
    rec = _record
    if rec is None:
        return
    with rec._lock:
        if rec._open:
            rec.counters[name] = rec.counters.get(name, 0) + int(n)


def current() -> Optional[Record]:
    """The :class:`Record` of the :func:`recording` open now, or None."""
    return _record


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record every span and counter of the process, on every thread, for
    the block; yields the :class:`Record`. Recording blocks do not nest."""
    global _record
    if _record is not None:
        raise RuntimeError("a span recording is already open")
    rec = _record = Record()
    try:
        yield rec
    finally:
        _record = None
        end = time.time_ns()
        with rec._lock:
            rec._open = False
            for i, s in enumerate(rec.spans):
                if s.end_ns < 0:  # still open on another thread: cut at the block's end
                    rec.spans[i] = s._replace(end_ns=end)
