"""The port's token-budget length bucketing against the JAX package (CPU).

``bucket_boundaries``, ``LengthBucketBatcher.batches`` and ``pad_to`` of
``avsl_tpu_torch.data.batching`` against ``avsl_tpu.data.batching``:
identical ``(indices, padded_len)`` sequences, exactly, over seeded length
sets (one with items past the last boundary, which land in overflow
buckets), ``num_shards`` 1 and 4, ``drop_last`` on and off, shuffled over
several epochs and in order.
"""

import numpy as np
import pytest

from avsl_tpu.data import batching as jax_batching
from avsl_tpu_torch.data import batching
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

# (lengths in 100 Hz frames, explicit boundaries or None, batch_bins)
LENGTH_SETS = {
    # the AMI shape: 0.5-10 s segments under a 10 s budget
    "ami": (lambda rng: rng.integers(50, 1001, size=97), None, 1000),
    # boundaries that stop short, so the longer items overflow
    "overflow": (lambda rng: rng.integers(1, 900, size=64), [100, 200, 300], 1200),
    # many short items: batches end at max_batch_size or the budget
    "short": (lambda rng: rng.integers(1, 40, size=300), None, 4000),
}


@pytest.mark.parametrize("growth", [1.4142135, 2.0])
@pytest.mark.parametrize("bounds", [(100, 3000), (100, 100), (50, 1001), (7, 19)])
def test_torch_bucket_boundaries_match_jax(bounds, growth):
    assert batching.bucket_boundaries(*bounds, growth) == \
        jax_batching.bucket_boundaries(*bounds, growth)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("name", sorted(LENGTH_SETS))
def test_torch_length_bucket_batches_match_jax(name, num_shards, drop_last):
    make, bounds, bins = LENGTH_SETS[name]
    lengths = make(np.random.default_rng(11))
    kw = dict(boundaries=bounds, num_shards=num_shards, drop_last=drop_last, seed=5)
    port = batching.LengthBucketBatcher(lengths, bins, **kw)
    ref = jax_batching.LengthBucketBatcher(lengths, bins, **kw)
    assert port.boundaries == ref.boundaries
    seen = 0
    for shuffle, epochs in ((True, range(3)), (False, [0])):
        for epoch in epochs:
            got = list(port.batches(shuffle=shuffle, epoch=epoch))
            want = list(ref.batches(shuffle=shuffle, epoch=epoch))
            assert len(got) == len(want) > 1
            for (gi, gp), (wi, wp) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                assert gp == wp and gp >= lengths[gi].max() and len(gi) % num_shards == 0
                seen += int(name == "overflow" and gp > bounds[-1])
    if name == "overflow":
        assert seen > 0  # overflow buckets were emitted


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("length", [2, 5, 9])
def test_torch_pad_to_matches_jax(length, axis):
    a = np.arange(30, dtype=np.float32).reshape(5, 6)
    got = batching.pad_to(a, length, axis=axis, value=-1)
    want = jax_batching.pad_to(a, length, axis=axis, value=-1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
