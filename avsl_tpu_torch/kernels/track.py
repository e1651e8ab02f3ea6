"""Template tracking by normalised cross-correlation, on a device.

Port of ``avsl_tpu/kernels/track.py``. A template cut around the mouth at
an anchor frame is correlated against a search window in other frames:

    NCC = <w - mean(w), t - mean(t)> / (||w - mean(w)|| * ||t - mean(t)||)

for every offset, by three correlations (raw, local sum, local sum of
squares). The anchored tracker scans the frames in order, each search
window following the previous position (the JAX ``lax.scan``); the
parallel tracker matches every frame independently inside one static
window. Both run batched over clips, with the search windows gathered on
the device (no host round trip a frame). The correlations are
``conv2d`` in float32; TF32 is kept off for them, since it would round the
pixel values the argmax compares.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F


@contextmanager
def _no_tf32_conv():
    """cuDNN convolutions without TF32 for the body, other flags kept."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _corr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation of each of B stacks with its own kernel:
    x [B, N, H, W], k [B, h, w] -> [B, N, H-h+1, W-w+1]."""
    b = x.shape[0]
    with _no_tf32_conv():
        out = F.conv2d(x.transpose(0, 1), k[:, None].to(x.dtype), groups=b)
    return out.transpose(0, 1)


def _ncc(windows: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """NCC of each clip's template [B, th, tw] at every valid offset in
    its windows [B, N, H, W] -> [B, N, S_h, S_w] (1e-6 floors as in JAX)."""
    windows = windows.float()
    t = template.float()
    n = t.shape[-2] * t.shape[-1]
    t_zero = t - t.mean(dim=(-2, -1), keepdim=True)
    t_norm = (t_zero * t_zero).sum(dim=(-2, -1)).clamp_min(1e-6).sqrt()
    raw = _corr(windows, t_zero)  # <w, t0> = <w0, t0> since sum(t0) = 0
    ones = torch.ones_like(t)
    local_sum = _corr(windows, ones)
    local_sq = _corr(windows * windows, ones)
    local_var = (local_sq - local_sum * local_sum / n).clamp_min(1e-6)
    return raw / (local_var.sqrt() * t_norm[:, None, None, None])


def ncc_scores(window: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """NCC of ``template`` [h, w] at every valid offset inside ``window``
    [H, W] -> [H-h+1, W-w+1]."""
    return _ncc(window[None, None], template[None])[0, 0]


def _dyn_slice(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Per-clip windows x[b, ..., y0[b]:y0[b]+hh, x0[b]:x0[b]+ww] of x [B, H, W]
    or [B, N, H, W], starts clamped into the frame (``lax.dynamic_slice``)."""
    h, w = x.shape[-2:]
    frames = x if x.dim() == 4 else x[:, None]
    y0 = y0.long().clamp(0, max(h - hh, 0))
    x0 = x0.long().clamp(0, max(w - ww, 0))
    rows = y0[:, None] + torch.arange(hh, device=x.device)  # [B, hh]
    cols = x0[:, None] + torch.arange(ww, device=x.device)  # [B, ww]
    b = torch.arange(frames.shape[0], device=x.device)[:, None, None, None]
    n = torch.arange(frames.shape[1], device=x.device)[None, :, None, None]
    out = frames[b, n, rows[:, None, :, None], cols[:, None, None, :]]
    return out if x.dim() == 4 else out[:, 0]


def _argmax_centers(scores: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, half: int) -> torch.Tensor:
    """(x, y) centres of the best offsets: scores [B, N, S, S] from
    windows at origins (wx, wy) [B] -> [B, N, 2] (first maximum on ties)."""
    s = scores.shape[-1]
    flat = scores.flatten(-2).argmax(dim=-1)  # [B, N]
    cy = wy.float()[:, None] + half + (flat // s).float()
    cx = wx.float()[:, None] + half + (flat % s).float()
    return torch.stack([cx, cy], dim=-1)


def ncc_track_batch_anchored(
    clips: torch.Tensor,  # [B, T, H, W]
    anchor_pos: torch.Tensor,  # [B, 2] (x, y) centre at the anchor frame
    anchor: int,
    template_size: int = 48,
    search: int = 24,
) -> torch.Tensor:
    """Bidirectional fixed-template tracking from a mid-clip anchor:
    [B, T, 2] (x, y) centres.

    The template is cut at frame ``anchor`` and tracked forward to the end
    and backward to frame 0, each frame searched within ``±search`` px of
    the previous position. Positions clamp by the template half only; the
    search window's origin clamps into the frame on its own and offsets
    map back through it."""
    b, t_len, h, w = clips.shape
    ts = template_size
    half = ts // 2
    win = ts + 2 * search

    def clamp(p):
        x = p[:, 0].clamp(half, w - half - 1)
        y = p[:, 1].clamp(half, h - half - 1)
        return torch.stack([x, y], dim=-1)

    p0 = clamp(anchor_pos.float())
    template = _dyn_slice(clips[:, anchor].float(), (p0[:, 1] - half).long(),
                          (p0[:, 0] - half).long(), ts, ts)
    out = torch.empty((b, t_len, 2), dtype=torch.float32, device=clips.device)

    def step(pos, i):
        pos = clamp(pos)
        wx = (pos[:, 0] - half - search).long().clamp(0, w - win)
        wy = (pos[:, 1] - half - search).long().clamp(0, h - win)
        window = _dyn_slice(clips[:, i].float(), wy, wx, win, win)
        new = clamp(_argmax_centers(_ncc(window[:, None], template), wx, wy, half)[:, 0])
        out[:, i] = new
        return new

    pos = p0
    for i in range(anchor, t_len):
        pos = step(pos, i)
    pos = p0
    for i in range(anchor - 1, -1, -1):
        pos = step(pos, i)
    return out


def ncc_track_clip_anchored(frames: torch.Tensor, anchor_pos: torch.Tensor, anchor: int,
                            template_size: int = 48, search: int = 24) -> torch.Tensor:
    """:func:`ncc_track_batch_anchored` for one clip [T, H, W] -> [T, 2]."""
    return ncc_track_batch_anchored(frames[None], anchor_pos[None], anchor,
                                    template_size=template_size, search=search)[0]


def ncc_track_clip(frames: torch.Tensor, init_pos: torch.Tensor,
                   template_size: int = 48, search: int = 24) -> torch.Tensor:
    """Track the patch centred at ``init_pos`` in frame 0 through the clip
    [T, H, W] -> [T, 2]: the anchored tracker with ``anchor=0``."""
    return ncc_track_clip_anchored(frames, init_pos, 0, template_size=template_size, search=search)


def ncc_track_batch(clips: torch.Tensor, init_pos: torch.Tensor,
                    template_size: int = 48, search: int = 24) -> torch.Tensor:
    """[B, T, 2] positions for a clip batch [B, T, H, W] from frame 0."""
    return ncc_track_batch_anchored(clips, init_pos, 0, template_size=template_size, search=search)


def ncc_track_batch_parallel(
    clips: torch.Tensor,  # [B, T, H, W]
    anchor_pos: torch.Tensor,  # [B, 2] (x, y) centre at the anchor frame
    anchor: int,
    template_size: int = 48,
    search: int = 80,
) -> torch.Tensor:
    """Scan-free anchored tracking: every frame matched independently
    against the anchor template inside ONE static search window around the
    anchor position (``search`` covers the clip's whole excursion, shrunk
    so the window fits the frame), as one batched correlation. Temporal
    coherence comes back through the smoothing every caller applies.
    Returns [B, T, 2] (x, y) centres."""
    b, t_len, h, w = clips.shape
    ts = template_size
    half = ts // 2
    search = min(search, (min(h, w) - ts - 2) // 2)
    ap = anchor_pos.float()
    px = ap[:, 0].clamp(half, w - half - 1)
    py = ap[:, 1].clamp(half, h - half - 1)
    template = _dyn_slice(clips[:, anchor].float(), (py - half).long(), (px - half).long(), ts, ts)
    win = ts + 2 * search
    wx = (px - half - search).long().clamp(0, w - win)
    wy = (py - half - search).long().clamp(0, h - win)
    windows = _dyn_slice(clips, wy, wx, win, win)  # [B, T, win, win], still in the clips' dtype
    return _argmax_centers(_ncc(windows, template), wx, wy, half)


def ncc_track_clip_parallel(frames: torch.Tensor, anchor_pos: torch.Tensor, anchor: int,
                            template_size: int = 48, search: int = 80) -> torch.Tensor:
    """:func:`ncc_track_batch_parallel` for one clip [T, H, W] -> [T, 2]."""
    return ncc_track_batch_parallel(frames[None], anchor_pos[None], anchor,
                                    template_size=template_size, search=search)[0]
