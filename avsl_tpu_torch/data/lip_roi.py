"""Lip-ROI extraction: per-frame landmarks -> 96x96 grayscale lip clips.

Port of ``avsl_tpu/data/lip_roi.py``. Host numpy for the landmark
bookkeeping: frames without a detection are filled by linear
interpolation and edge fill, the landmarks are smoothed over a sliding
window of min(T, 12) frames, then :func:`extract_lip_clip` warps every
frame so the stable points (33, 36, 39, 42, 45) meet a canonical 300x300
mean face and cuts a 96x96 patch around the mouth (48..67). The warp runs
on the device the caller names, the card by default. The canonical mean
face is parametric; any [68, 2] array can stand in for it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

STABLE_POINTS = (33, 36, 39, 42, 45)


def load_mean_face(path: str) -> np.ndarray:
    """Load a [68, 2] mean-face landmark array from a ``.npy`` file."""
    mf = np.asarray(np.load(path), np.float32)
    if mf.shape != (68, 2):
        raise ValueError(f"mean face at {path!r} has shape {mf.shape}, expected (68, 2)")
    if not np.all(np.isfinite(mf)):
        raise ValueError(f"mean face at {path!r} contains non-finite values")
    return mf


def resolve_mean_face(mean_face_path: Optional[str] = None, out_size: int = 300) -> np.ndarray:
    """``mean_face_path`` config key -> [68, 2] landmarks: the file when
    given, else the parametric canonical face."""
    if mean_face_path:
        return load_mean_face(mean_face_path)
    return canonical_mean_face(out_size)


def layout_face_width(layout: np.ndarray) -> float:
    """Jaw x-span of a 68-point layout (156 for the parametric face), the
    scale anchor of landmark synthesis. Synthesis layout and warp mean face
    must be the same geometry, or the stable-point fit adds a systematic
    crop scale and offset."""
    jaw = np.asarray(layout, np.float64)[:17]
    return float(jaw[:, 0].max() - jaw[:, 0].min())


def layout_face_width_at_mouth(layout: np.ndarray) -> float:
    """Jaw x-span at the mouth centroid's height (about 120 for the
    parametric face), the scale anchor of detectors that measure the face
    width at mouth level."""
    lay = np.asarray(layout, np.float64)
    mouth_y = float(lay[48:68, 1].mean())

    # np.interp needs increasing xp, and a supplied mean face need not have
    # y-monotone jaw halves: sort by y
    def _x_at_y(pts: np.ndarray) -> float:
        order = np.argsort(pts[:, 1], kind="stable")
        return float(np.interp(mouth_y, pts[order, 1], pts[order, 0]))

    lx = _x_at_y(lay[:9])  # left temple -> chin
    rx = _x_at_y(lay[8:17])  # chin -> right temple
    return rx - lx


def relayout_landmarks(lms: np.ndarray, target_layout: np.ndarray) -> np.ndarray:
    """Re-express synthesized (rigid-layout) landmarks [..., 68, 2] in
    another layout, anchoring the mouth centroid and the outer-eye x-span
    (36 <-> 45), which carry over between layout families. Real per-point
    detections are left to the warp's similarity fit."""
    lms = np.asarray(lms, np.float32)
    tgt = np.asarray(target_layout, np.float64)
    tgt_mouth = tgt[48:68].mean(axis=0)
    tgt_span = float(tgt[45, 0] - tgt[36, 0])
    span = lms[..., 45, 0] - lms[..., 36, 0]  # [...]
    mouth = lms[..., 48:68, :].mean(axis=-2)  # [..., 2]
    s = span / tgt_span
    return (s[..., None, None] * (tgt - tgt_mouth) + mouth[..., None, :]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def canonical_mean_face(size: int = 300) -> np.ndarray:
    """Parametric 68-landmark canonical face in a ``size`` x ``size`` frame
    (iBUG 68 layout: 0-16 jaw, 17-26 brows, 27-35 nose, 36-47 eyes, 48-67
    mouth)."""
    s = size / 300.0
    pts = np.zeros((68, 2), np.float64)

    # jaw: half-ellipse from the left temple through the chin to the right
    t = np.linspace(np.pi, 2 * np.pi, 17)
    pts[0:17, 0] = 150 + 78 * np.cos(t)
    pts[0:17, 1] = 128 + 142 * np.sin(t - np.pi)

    # eyebrows
    for i, x in enumerate(np.linspace(95, 140, 5)):
        pts[17 + i] = (x, 108 - 6 * np.sin(np.pi * i / 4))
    for i, x in enumerate(np.linspace(160, 205, 5)):
        pts[22 + i] = (x, 108 - 6 * np.sin(np.pi * i / 4))

    # nose bridge 27-30
    for i in range(4):
        pts[27 + i] = (150, 125 + i * 15)
    # nostrils 31-35
    for i, x in enumerate(np.linspace(132, 168, 5)):
        pts[31 + i] = (x, 182)
    pts[33] = (150, 184)  # subnasale (stable point)

    # eyes 36-41 (left), 42-47 (right): hexagons
    def eye(cx, cy, w, h, base):
        xs = [cx - w, cx - w / 2, cx + w / 2, cx + w, cx + w / 2, cx - w / 2]
        ys = [cy, cy - h, cy - h, cy, cy + h, cy + h]
        for j in range(6):
            pts[base + j] = (xs[j], ys[j])

    eye(120, 128, 15, 6, 36)
    eye(180, 128, 15, 6, 42)

    # mouth: outer ellipse 48-59, inner 60-67
    cx, cy = 150, 218
    outer_t = np.linspace(np.pi, 3 * np.pi, 13)[:-1]
    pts[48:60, 0] = cx + 30 * np.cos(outer_t)
    pts[48:60, 1] = cy + 13 * np.sin(outer_t)
    inner_t = np.linspace(np.pi, 3 * np.pi, 9)[:-1]
    pts[60:68, 0] = cx + 18 * np.cos(inner_t)
    pts[60:68, 1] = cy + 6 * np.sin(inner_t)

    return (pts * s).astype(np.float32)


def landmarks_interpolate(landmarks: Sequence[Optional[np.ndarray]]) -> Optional[np.ndarray]:
    """Fill missing per-frame landmarks (None) by linear interpolation
    between consecutive detections and edge fill: [T, 68, 2], or None when
    no frame has one."""
    valid = [i for i, l in enumerate(landmarks) if l is not None]
    if not valid:
        return None
    T = len(landmarks)
    out = np.zeros((T, 68, 2), np.float32)
    for i in valid:
        out[i] = landmarks[i]
    for a, b in zip(valid[:-1], valid[1:]):
        if b - a > 1:
            for j in range(a + 1, b):
                w = (j - a) / (b - a)
                out[j] = (1 - w) * out[a] + w * out[b]
    first, last = valid[0], valid[-1]
    out[:first] = out[first]
    out[last + 1:] = out[last]
    return out


def smooth_landmarks(landmarks: np.ndarray, window: int = 12) -> np.ndarray:
    """Sliding mean over time with a min(T, window) symmetric window,
    clamped at the clip's ends (prefix sums in float64)."""
    t = landmarks.shape[0]
    win = min(t, window)
    half = win // 2
    c = np.concatenate(
        [np.zeros((1,) + landmarks.shape[1:], np.float64),
         np.cumsum(landmarks.astype(np.float64), axis=0)]
    )
    idx = np.arange(t)
    lo = np.maximum(0, idx - half)
    hi = np.minimum(t, idx + half + 1)
    out = (c[hi] - c[lo]) / (hi - lo).reshape(-1, *([1] * (landmarks.ndim - 1)))
    return out.astype(landmarks.dtype)


def extract_lip_clip(
    frames: np.ndarray,  # [T, H, W] grayscale
    per_frame_landmarks: Sequence[Optional[np.ndarray]],
    mean_face: Optional[np.ndarray] = None,
    out_size: int = 300,
    crop_size: int = 96,
    smoothing_window: int = 12,
    device: Union[str, torch.device] = "cuda",
) -> Optional[np.ndarray]:
    """The whole pipeline for one clip: [T, crop, crop] uint8 (clipped to
    [0, 255] and truncated), or None when no frame has landmarks. The warp
    (:func:`~avsl_tpu_torch.kernels.warp.warp_and_crop_clip`) runs on
    ``device``."""
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.kernels.warp import warp_and_crop_clip

    lms = landmarks_interpolate(per_frame_landmarks)
    if lms is None:
        return None
    lms = smooth_landmarks(lms, smoothing_window)
    mean_face = canonical_mean_face(out_size) if mean_face is None else mean_face
    dev = resolve_device(device)
    clip = warp_and_crop_clip(
        torch.as_tensor(np.asarray(frames), device=dev).float(),
        torch.as_tensor(lms, device=dev),
        torch.as_tensor(np.asarray(mean_face, np.float32), device=dev),
        out_size=out_size,
        crop_size=crop_size,
    )
    return np.clip(clip.cpu().numpy(), 0, 255).astype(np.uint8)
