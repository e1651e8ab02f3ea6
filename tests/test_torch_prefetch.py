"""The port's host-to-device prefetch iterator (CPU), as
``tests/test_prefetch.py`` holds the JAX one: order kept, tensors on the
requested device, a source error re-raised at the consumer, an abandoned
consumer's producer ends, a mesh hands each rank its rows. The CUDA
stream path runs in the ``prefetch`` phase of the card gate at the
repository root."""

import threading
import time

import numpy as np
import pytest
import torch

from avsl_tpu_torch.data.prefetch import prefetch_to_device
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)


def _batches(n):
    for i in range(n):
        yield {"x": np.full((8, 4), i, np.float32), "i": np.full((8,), i),
               "m": np.arange(8) < i}


def test_torch_prefetch_order_and_device():
    out = list(prefetch_to_device(_batches(5), "cpu", size=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in b.values())
        assert int(b["i"][0]) == i and b["i"].dtype == torch.int64
        assert b["m"].dtype == torch.bool and int(b["m"].sum()) == min(i, 8)
        np.testing.assert_array_equal(b["x"].numpy(), np.full((8, 4), i, np.float32))


def test_torch_prefetch_source_errors_propagate():
    def bad():
        yield {"x": np.zeros(3, np.float32)}
        raise RuntimeError("decode failed")

    it = prefetch_to_device(bad(), "cpu", size=2)
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_torch_prefetch_abandoned_consumer_releases_producer():
    before = threading.active_count()
    it = prefetch_to_device(_batches(100), "cpu", size=1)
    next(it)
    it.close()  # abandon mid-stream
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before  # the producer exited


def test_torch_prefetch_mesh_raises():
    """With a mesh each batch arrives as this data rank's rows (a
    ``ShardedBatch`` the train step takes as it is); an object that is no
    mesh raises."""
    from types import SimpleNamespace

    from avsl_tpu_torch.core.mesh import ShardedBatch

    mesh = SimpleNamespace(shape={"data": 2, "model": 1}, data_rank=1,
                           device=torch.device("cpu"))
    out = list(prefetch_to_device(_batches(3), "cpu", size=2, mesh=mesh))
    assert len(out) == 3
    for i, b in enumerate(out):
        assert isinstance(b, ShardedBatch) and b.sharded == frozenset(b)
        full = next(iter(_batches(1)))
        assert all(b[k].shape[0] == full[k].shape[0] // 2 for k in b)
        assert int(b["i"][0]) == i
    with pytest.raises(AttributeError):
        next(prefetch_to_device(_batches(1), "cpu", mesh=object()))
