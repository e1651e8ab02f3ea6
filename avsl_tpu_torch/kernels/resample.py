"""Polyphase resampling by a rational factor.

Port of ``avsl_tpu/kernels/resample.py``. The JAX version is one XLA
convolution: zero-stuff the signal by ``up``, apply a centred FIR, keep
every ``down``-th sample. Here the same function is computed polyphase:
of the ``numtaps`` taps, only those that land on a real (not stuffed)
sample are used, about ``numtaps / up`` of them per output, so the
zero-stuffed signal (``up`` times the input, 160 times at 44.1 -> 16 kHz)
is never built. Output ``j = q * up + s`` takes the taps ``h[r_s + i *
up]`` against the inputs ``x[q * down + n0_s + i]``; the phase ``r_s`` and
the offset ``n0_s`` depend only on ``s``, so one gather of ``unfold``
windows and one product per phase give every output.

The filter is scipy.signal.resample_poly's (Kaiser beta 5, half-length
``10 * max(up, down)``, DC-normalised, times ``up``), so the output is
scipy's length, ``ceil(n * up / down)``.
"""

from __future__ import annotations

import functools
import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

# elements of the gathered windows per chunk of outputs, which bounds the
# temporaries (64 MB of fp32)
_CHUNK_ELEMENTS = 1 << 24


@functools.lru_cache(maxsize=32)
def _design_filter(up: int, down: int) -> np.ndarray:
    max_rate = max(up, down)
    f_c = 1.0 / max_rate  # cutoff in Nyquist-normalized units
    half_len = 10 * max_rate
    numtaps = 2 * half_len + 1
    m = np.arange(numtaps, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * m)
    h *= np.kaiser(numtaps, 5.0)
    h /= h.sum()  # firwin scale=True at DC
    return (h * up).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _polyphase_plan(up: int, down: int):
    """``(taps [up, k], n0 [up])``: output phase ``s`` uses the taps
    ``h[r_s + i * up]`` (zero past the filter) against the inputs from
    ``q * down + n0[s]`` on, ``k = ceil(numtaps / up)`` of them."""
    h = _design_filter(up, down)
    half_len = (len(h) - 1) // 2
    k = -(-len(h) // up)
    padded = np.zeros(k * up, np.float32)
    padded[: len(h)] = h
    by_phase = padded.reshape(k, up).T  # [r, i] = h[r + i * up]
    s = np.arange(up)
    r = (half_len - s * down) % up
    n0 = (s * down - half_len + r) // up  # exact: the numerator is a multiple of up
    return np.ascontiguousarray(by_phase[r]), n0


def resample_poly(x: Union[np.ndarray, torch.Tensor], orig_sr: int,
                  target_sr: int) -> torch.Tensor:
    """Resample along the last axis (1-D or ``[B, N]``) from ``orig_sr`` to
    ``target_sr``, in fp32 on the input's device (numpy input: the CPU).
    Equal rates return the input unchanged."""
    x = torch.as_tensor(x)
    if orig_sr == target_sr:
        return x
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = int(target_sr) // g, int(orig_sr) // g
    taps_np, n0 = _polyphase_plan(up, down)
    taps = torch.from_numpy(taps_np).to(x.device)
    k = taps.shape[1]
    squeeze = x.ndim == 1
    x = x.reshape(1, -1) if squeeze else x
    x = x.to(torch.float32)
    n = x.shape[-1]
    out_len = -(-n * up // down)
    blocks = -(-out_len // up)
    # pad so that every window lies inside: offsets n0 + left >= 0, and the
    # last block's windows end inside the padded signal
    left = max(0, -int(n0.min()))
    offsets = n0 + left
    span = int(offsets.max()) + k
    right = max(0, (blocks - 1) * down + span - n - left)
    padded = F.pad(x, (left, right))
    windows = padded.unfold(-1, span, down)[:, :blocks]  # a view [B, blocks, span]
    index = torch.from_numpy(offsets[:, None] + np.arange(k)).to(x.device)  # [up, k]
    per_chunk = max(1, _CHUNK_ELEMENTS // (x.shape[0] * up * k))
    out = torch.cat([
        torch.einsum("bqsi,si->bqs", windows[:, lo:lo + per_chunk][..., index], taps)
        for lo in range(0, blocks, per_chunk)
    ], dim=1).reshape(x.shape[0], blocks * up)[:, :out_len]
    return out[0] if squeeze else out
