"""Host-to-device prefetching iterator (double buffering).

Port of ``avsl_tpu/data/prefetch.py``: a producer thread uploads batch N+1
while the train step consumes batch N. On a CUDA device each batch is
copied from pinned host memory on a stream of its own with
``non_blocking=True``; the consumer's stream waits on the copy's event
before it reads the batch, and the tensors are recorded on that stream so
the caching allocator does not hand their memory back to the copy stream
while the step still reads it. With ``mesh`` each rank uploads only its
rows of every batch (``core/mesh.py::shard_batch``), to the mesh's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from avsl_tpu_torch.utils.spans import count, span


class _End:
    pass


class _Err:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(
    iterator: Iterator[Dict[str, Any]],
    device: Union[str, torch.device],
    size: int = 2,
    mesh: Optional[Any] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host-batch iterator (dicts of numpy arrays or tensors) so its
    batches arrive as tensors on ``device``.

    ``size`` bounds the batches in flight (2 = double buffering). With
    ``mesh`` each batch arrives as this data rank's
    :class:`~avsl_tpu_torch.core.mesh.ShardedBatch` on the mesh's device
    (``device`` is then the mesh's), which the train step takes as it is.
    Exceptions raised by the source iterator or by an upload re-raise at the
    consumer's ``next()``; the producer is a daemon thread that stops once
    the consumer is closed or dropped, so an abandoned consumer cannot keep
    it parked on a full queue."""
    from avsl_tpu_torch.core.mesh import ShardedBatch, host_rows

    device = torch.device(device) if mesh is None else mesh.device
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def host(value) -> torch.Tensor:
        return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))

    def put(batch):
        sharded = None
        if mesh is not None:
            batch, sharded = host_rows(mesh, batch)
        batch = {k: host(v) for k, v in batch.items()}
        count("h2d_bytes", sum(t.nbytes for t in batch.values()))
        if not cuda:
            out, done = {k: t.to(device) for k, t in batch.items()}, None
        else:
            with torch.cuda.stream(copy_stream):
                out = {k: t.pin_memory().to(device, non_blocking=True)
                       for k, t in batch.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
        return (out if sharded is None else ShardedBatch(out, sharded, 0)), done

    def enqueue(item) -> bool:
        # a bounded put that notices an abandoned consumer instead of
        # parking forever on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not enqueue(put(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 (relayed to the consumer)
            enqueue(_Err(e))
            return
        enqueue(_End())

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            with span("data.wait"):
                item = q.get()
            if isinstance(item, _End):
                return
            if isinstance(item, _Err):
                raise item.exc
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in batch.values():
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()  # consumer done or closed: release the producer
