"""Host twin of the scan-free anchored NCC tracker, numpy and OpenCV.

Port of ``avsl_tpu/data/track_host.py``: ``ncc_track_batch_parallel``
(``avsl_tpu_torch/kernels/track.py``) formulated for the CPU. One static
search window around the anchor position is sliced from every frame and
the fixed anchor template is NCC-matched (zero-mean normalised cross
correlation, the device tracker's statistic) against all of them. Fast
path: ``cv2.matchTemplate`` with ``TM_CCOEFF_NORMED``; without OpenCV, FFT
correlation and integral-image local moments in numpy. The clamping is the
device tracker's, so host and device trajectories agree up to argmax ties.

``stride`` tracks every ``stride``-th frame and interpolates between
(the trajectory is smoothed over 12 frames downstream anyway); ``top_k >
1`` picks among the top-k peaks a frame by a Viterbi pass that charges
motion.
"""

from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np

# OpenCV is optional and imported only where it matches (hosts without it,
# the card's among them, take the numpy path)
_HAS_CV2 = importlib.util.find_spec("cv2") is not None


def _ncc_scores_np(windows: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Zero-mean NCC of ``template`` at every valid offset in each window.

    windows [T, H, W] float32, template [h, w] float32 ->
    [T, H-h+1, W-w+1]. FFT raw correlation + integral-image local sums,
    matching kernels/track.py:ncc_scores (incl. the 1e-6 floors).
    """
    t_len, h, w = windows.shape
    th, tw = template.shape
    n = th * tw
    t_zero = template - template.mean()
    t_norm = np.sqrt(max(float((t_zero * t_zero).sum()), 1e-6))

    # raw correlation <w, t0> via FFT (correlation = conv with flipped k)
    fh, fw = h + th - 1, w + tw - 1
    fw2 = (int(2 ** np.ceil(np.log2(fh))), int(2 ** np.ceil(np.log2(fw))))
    fwin = np.fft.rfft2(windows, fw2)
    fker = np.fft.rfft2(t_zero[::-1, ::-1], fw2)
    full = np.fft.irfft2(fwin * fker[None], fw2)
    raw = full[:, th - 1: h, tw - 1: w]  # VALID region

    # local sum / sum-sq via integral images
    def local(x):
        c = np.cumsum(np.cumsum(x, axis=1), axis=2)
        c = np.pad(c, ((0, 0), (1, 0), (1, 0)))
        return (
            c[:, th:, tw:] - c[:, :-th, tw:] - c[:, th:, :-tw]
            + c[:, :-th, :-tw]
        )

    ls = local(windows)
    lq = local(windows * windows)
    local_var = np.maximum(lq - ls * ls / n, 1e-6)
    return raw / (np.sqrt(local_var) * t_norm)


def _topk_peaks(score: np.ndarray, k: int, suppress: int):
    """Top-k local maxima of a 2-D score map with square non-max
    suppression of side ``2*suppress+1``. Returns ([k, 2] (row, col),
    [k] scores); missing peaks repeat the best one."""
    s = score.copy()
    hh, ww = s.shape
    rows = np.empty((k,), np.int64)
    cols = np.empty((k,), np.int64)
    vals = np.empty((k,), np.float32)
    for i in range(k):
        flat = int(np.argmax(s))
        r, c = flat // ww, flat % ww
        if i > 0 and not np.isfinite(s[r, c]):
            rows[i:], cols[i:], vals[i:] = rows[0], cols[0], vals[0]
            break
        rows[i], cols[i], vals[i] = r, c, score[r, c]
        s[max(0, r - suppress): r + suppress + 1,
          max(0, c - suppress): c + suppress + 1] = -np.inf
    return np.stack([rows, cols], axis=-1), vals


def _viterbi_peaks(peaks: np.ndarray, vals: np.ndarray, anchor_i: int,
                   motion_lambda: float, stride: int) -> np.ndarray:
    """Temporally-coherent peak selection: pick one of the k NCC peaks
    per frame minimizing sum(-score) + motion_lambda/stride * sum(step
    distance), with the anchor frame pinned to its best peak. peaks
    [T, K, 2] (row, col), vals [T, K] -> [T] chosen indices."""
    t_len, k, _ = peaks.shape
    lam = motion_lambda / max(stride, 1)
    cost = np.zeros((t_len, k), np.float32)
    back = np.zeros((t_len, k), np.int64)
    big = np.float32(1e6)
    cost[anchor_i] = np.where(np.arange(k) == 0, -vals[anchor_i, 0], big)

    def sweep(rng):
        p = anchor_i
        for t in rng:
            d = np.linalg.norm(
                peaks[t][:, None, :] - peaks[p][None, :, :], axis=-1
            )  # [k_t, k_prev]
            tot = cost[p][None, :] + lam * d
            back[t] = np.argmin(tot, axis=1)
            cost[t] = tot[np.arange(k), back[t]] - vals[t]
            p = t

    sweep(range(anchor_i + 1, t_len))
    sweep(range(anchor_i - 1, -1, -1))

    choice = np.zeros((t_len,), np.int64)
    if anchor_i + 1 < t_len:
        choice[t_len - 1] = int(np.argmin(cost[t_len - 1]))
        for t in range(t_len - 2, anchor_i, -1):
            choice[t] = back[t + 1][choice[t + 1]]
    if anchor_i > 0:
        choice[0] = int(np.argmin(cost[0]))
        for t in range(1, anchor_i):
            choice[t] = back[t - 1][choice[t - 1]]
    return choice


def ncc_track_clip_parallel_np(
    frames: np.ndarray,  # [T, H, W] (uint8 or float)
    anchor_pos: np.ndarray,  # (x, y) center at the anchor frame
    anchor: int,
    template_size: int = 48,
    search: int = 80,
    stride: int = 1,
    top_k: int = 1,
    motion_lambda: float = 0.02,
) -> np.ndarray:
    """[T, 2] (x, y) tracked centers — host twin of the device kernel.

    ``top_k > 1`` enables temporally-coherent peak selection (host-only
    upgrade over the device kernel's per-frame argmax): the ``top_k``
    non-max-suppressed NCC peaks per frame feed a Viterbi pass that
    minimizes ``sum(-ncc) + motion_lambda * sum(px moved per frame)``,
    anchored at the template frame. This resolves the per-frame-argmax
    failure mode where a distant look-alike peak narrowly outscores the
    true mouth during fast early-clip motion — a tie that flips with
    1 px of anchor jitter — by charging implausible jumps for their
    motion. With ``top_k=1`` the result is bit-identical to
    kernels/track.py:ncc_track_clip_parallel (pinned by tests).
    """
    t_len, h, w = frames.shape
    ts = template_size
    half = ts // 2
    search = min(search, (min(h, w) - ts - 2) // 2)
    frames = np.asarray(frames)

    px = float(np.clip(anchor_pos[0], half, w - half - 1))
    py = float(np.clip(anchor_pos[1], half, h - half - 1))
    x0 = int(px - half)
    y0 = int(py - half)
    template = frames[anchor, y0: y0 + ts, x0: x0 + ts].astype(np.float32)

    win = ts + 2 * search
    wx = int(np.clip(int(px - half - search), 0, w - win))
    wy = int(np.clip(int(py - half - search), 0, h - win))
    idxs = np.arange(0, t_len, max(int(stride), 1))
    if idxs[-1] != t_len - 1:
        idxs = np.append(idxs, t_len - 1)
    anchor_i = int(np.argmin(np.abs(idxs - anchor)))
    # slice the strided window stack FIRST, convert after — converting
    # the whole clip to float32 costs more than all the NCC matching
    windows = frames[idxs, wy: wy + win, wx: wx + win].astype(np.float32)

    def score_map(i):
        if _HAS_CV2:
            import cv2

            return cv2.matchTemplate(windows[i], template, cv2.TM_CCOEFF_NORMED)
        return _ncc_scores_np(windows[i][None], template)[0]

    if top_k <= 1:
        flat = np.empty(len(idxs), np.int64)
        s = win - ts + 1
        for i in range(len(idxs)):
            flat[i] = int(np.argmax(score_map(i)))
        rc = np.stack([flat // s, flat % s], axis=-1)  # (row, col)
    else:
        peaks = np.empty((len(idxs), top_k, 2), np.int64)
        vals = np.empty((len(idxs), top_k), np.float32)
        for i in range(len(idxs)):
            peaks[i], vals[i] = _topk_peaks(score_map(i), top_k, half)
        choice = _viterbi_peaks(peaks, vals, anchor_i, motion_lambda, stride)
        rc = peaks[np.arange(len(idxs)), choice]

    cy = wy + half + rc[:, 0].astype(np.float32)
    cx = wx + half + rc[:, 1].astype(np.float32)
    pos = np.stack([cx, cy], axis=-1)  # [len(idxs), 2]
    if len(idxs) == t_len:
        return pos
    out = np.empty((t_len, 2), np.float32)
    for d in range(2):
        out[:, d] = np.interp(np.arange(t_len), idxs, pos[:, d])
    return out


def ncc_track_batch_parallel_np(
    clips: np.ndarray,  # [B, T, H, W]
    anchor_pos: np.ndarray,  # [B, 2]
    anchor: int,
    template_size: int = 48,
    search: int = 80,
    stride: int = 1,
    top_k: int = 1,
    motion_lambda: float = 0.02,
) -> np.ndarray:
    """[B, T, 2] — batch loop over :func:`ncc_track_clip_parallel_np`."""
    return np.stack([
        ncc_track_clip_parallel_np(
            clips[b], np.asarray(anchor_pos[b]), anchor,
            template_size=template_size, search=search, stride=stride,
            top_k=top_k, motion_lambda=motion_lambda,
        )
        for b in range(len(clips))
    ])
