"""Token-budget length bucketing.

Port of ``avsl_tpu/data/batching.py`` (``bucket_boundaries``,
``LengthBucketBatcher``, ``pad_to``), a numpy copy that gives the same
``(indices, padded_len)`` batches for the same lengths, seed, epoch,
``num_shards`` and ``drop_last``. A batch closes when its token budget
``batch_bins`` (padded length x items) would be exceeded, and its padded
length snaps to a small set of geometric bucket boundaries, so the batches
take few distinct shapes. Batches hold a multiple of ``num_shards`` items.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def bucket_boundaries(
    min_len: int = 100, max_len: int = 3000, growth: float = 1.4142135
) -> List[int]:
    """Geometric bucket upper bounds, e.g. [100, 142, 200, 283, ...]."""
    out = [min_len]
    while out[-1] < max_len:
        out.append(min(int(math.ceil(out[-1] * growth)), max_len))
    return out


class LengthBucketBatcher:
    """Assign items to length buckets; emit (indices, padded_len) batches.

    ``lengths``: per-item frame counts. A batch closes when
    ``padded_len * batch_size`` would exceed ``batch_bins`` (token budget)
    or when ``max_batch_size`` is hit. Items inside a batch are sorted by
    descending length (``sort_in_batch='descending'`` semantics).
    """

    def __init__(
        self,
        lengths: Sequence[int],
        batch_bins: int,
        max_batch_size: int = 128,
        boundaries: Optional[Sequence[int]] = None,
        num_shards: int = 1,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.lengths = np.asarray(lengths)
        self.batch_bins = int(batch_bins)
        self.max_batch_size = int(max_batch_size)
        self.boundaries = list(
            boundaries
            if boundaries is not None
            else bucket_boundaries(max_len=int(self.lengths.max()) if len(lengths) else 100)
        )
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.seed = seed

    def _bucket_of(self, length: int):
        """(bucket key, padded length). Items longer than the last
        boundary land in overflow buckets padded to the next multiple of
        the largest boundary — the padded length is always >= the item
        length (the top regular bucket would silently truncate them)."""
        for i, b in enumerate(self.boundaries):
            if length <= b:
                return i, b
        top = self.boundaries[-1]
        mult = -(-length // top)
        return ("overflow", mult), mult * top

    def batches(self, shuffle: bool = True, epoch: int = 0) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (item_indices, padded_len); len(indices) is always a
        multiple of num_shards (short batches are dropped or padded by
        repeating the last item)."""
        order = np.arange(len(self.lengths))
        if shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(order)

        pending: dict = {}
        for idx in order:
            L = int(self.lengths[idx])
            b, padded = self._bucket_of(L)
            cur = pending.setdefault(b, (padded, []))[1]
            cur.append(idx)
            if (len(cur) + 1) * padded > self.batch_bins or len(cur) >= self.max_batch_size:
                yield from self._emit(cur, padded)
                pending[b] = (padded, [])
        for b, (padded, cur) in pending.items():
            if cur and not self.drop_last:
                yield from self._emit(cur, padded)

    def _emit(self, indices: List[int], padded: int) -> Iterator[Tuple[np.ndarray, int]]:
        idx = np.asarray(indices)
        idx = idx[np.argsort(-self.lengths[idx])]  # sort_in_batch descending
        rem = len(idx) % self.num_shards
        if rem:
            pad_n = self.num_shards - rem
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad_n)])
        yield idx, padded


def pad_to(array: np.ndarray, length: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad (or truncate) ``array`` to ``length`` along ``axis``."""
    n = array.shape[axis]
    if n == length:
        return array
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, length - n)
    return np.pad(array, pad, constant_values=value)
