"""68-point landmark detectors: model-free ones and the CNN regressor.

Port of ``avsl_tpu/data/landmarks.py``. Every detector returns, per
frame, a [68, 2] float (x, y) array or None (no detection), the contract
:func:`avsl_tpu_torch.data.lip_roi.extract_lip_clip` takes:

* :class:`EnergyBoxDetector`: a face box from a centre-weighted
  gradient-energy profile, the canonical layout scaled into it;
* :class:`MotionEnergyDetector`: clip-level head box and mouth from
  temporal motion energy (the speaker is what moves; the mouth
  articulates fastest), per ~1 s window;
* :class:`BatchedMotionDetector`: the same over a clip batch with the
  dense maps and the detection logic on a device (``_device_maps_fn``,
  ``_device_detect_fn``);
* :class:`CNNLandmarkDetector`: the conv regressor :class:`LandmarkNet`
  over the clip in one batch on a device, with the weights shipped as
  ``data/assets/landmark_cnn.npz`` (flax's layout, shared with the JAX
  package: :func:`cnn_state_dict_from_flax` and
  :func:`cnn_state_dict_to_flax` carry them across);
* :class:`AnchorTrackDetector`: a mid-clip anchor tracked both ways by
  normalised cross-correlation (OpenCV);
* :class:`PrecomputedLandmarks`: landmarks served from arrays.

The host detectors are numpy, as in the JAX package; the device functions
are torch and run where their inputs are, in float32.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.data.lip_roi import canonical_mean_face
from avsl_tpu_torch.kernels.stats import nanmedian, nanquantile


class LandmarkDetector:
    # True when the output is a rigid affine image of the parametric
    # canonical layout rather than real per-point detections: a warp onto a
    # different mean face needs lip_roi.relayout_landmarks first
    synthesizes_parametric_layout = False

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        """frames [T, H, W] grayscale uint8 -> per-frame [68, 2] or None."""
        raise NotImplementedError


def canonical_landmarks_from_box(x: float, y: float, w: float, h: float) -> np.ndarray:
    """Scale the canonical 68-point layout (its face spans x 72..228, y
    100..270 of 300) into a face box."""
    canon = canonical_mean_face(300).astype(np.float64)
    cx0, cy0, cw, ch = 72.0, 100.0, 156.0, 170.0
    out = np.empty_like(canon)
    out[:, 0] = (canon[:, 0] - cx0) / cw * w + x
    out[:, 1] = (canon[:, 1] - cy0) / ch * h + y
    return out.astype(np.float32)


def _gradient_energy(frame: np.ndarray) -> np.ndarray:
    f = frame.astype(np.float32)
    gx = np.abs(np.diff(f, axis=1, prepend=f[:, :1]))
    gy = np.abs(np.diff(f, axis=0, prepend=f[:1]))
    return gx + gy


def _box_from_energy(energy: np.ndarray, center_sigma: float = 0.35,
                     keep_mass: float = 0.80) -> tuple:
    """Face box from the centre-weighted energy marginals: the tightest
    row and column spans holding ``keep_mass`` of the weighted energy."""
    h, w = energy.shape
    wy = np.exp(-0.5 * ((np.arange(h) - h / 2) / (center_sigma * h)) ** 2)
    wx = np.exp(-0.5 * ((np.arange(w) - w / 2) / (center_sigma * w)) ** 2)
    weighted = energy * wy[:, None] * wx[None, :]

    def span(profile: np.ndarray) -> tuple:
        total = profile.sum()
        if total <= 0:
            return 0, len(profile)
        target = (1.0 - keep_mass) / 2.0 * total
        c = np.cumsum(profile)
        lo = int(np.searchsorted(c, target))
        hi = int(np.searchsorted(c, total - target))
        return lo, max(hi, lo + 1)

    y0, y1 = span(weighted.sum(axis=1))
    x0, x1 = span(weighted.sum(axis=0))
    return x0, y0, x1 - x0, y1 - y0


class EnergyBoxDetector(LandmarkDetector):
    """Model-free centre-prior face box and the canonical landmark layout;
    ``every_n`` detects on every n-th frame only (the others are filled by
    interpolation downstream)."""

    synthesizes_parametric_layout = True

    def __init__(self, every_n: int = 1, center_sigma: float = 0.35,
                 keep_mass: float = 0.80, min_box: int = 24):
        self.every_n = max(every_n, 1)
        self.center_sigma = center_sigma
        self.keep_mass = keep_mass
        self.min_box = min_box

    def detect_face(self, frame: np.ndarray) -> Optional[tuple]:
        energy = _gradient_energy(frame)
        x, y, w, h = _box_from_energy(energy, self.center_sigma, self.keep_mass)
        if w < self.min_box or h < self.min_box:
            return None
        # squarish box: expand the shorter side about its centre
        side = max(w, h)
        cx, cy = x + w / 2, y + h / 2
        H, W = frame.shape
        side = min(side, min(H, W))
        x = float(np.clip(cx - side / 2, 0, W - side))
        y = float(np.clip(cy - side / 2, 0, H - side))
        return x, y, float(side), float(side)

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        out: List[Optional[np.ndarray]] = []
        for i, frame in enumerate(frames):
            if i % self.every_n:
                out.append(None)
                continue
            box = self.detect_face(np.asarray(frame))
            out.append(None if box is None else canonical_landmarks_from_box(*box))
        return out


def _box_blur(img: np.ndarray, k: int = 9) -> np.ndarray:
    """Separable box blur by cumulative sums (edge padding)."""
    if k <= 1:
        return img
    pad = k // 2
    out = np.pad(img, ((pad, pad), (pad, pad)), mode="edge").astype(np.float32)

    def smooth_axis0(a):
        c = np.cumsum(a, axis=0)
        c = np.concatenate([np.zeros_like(c[:1]), c], axis=0)
        return (c[k:] - c[:-k]) / k

    out = smooth_axis0(out)
    out = smooth_axis0(out.T).T
    return out


class MotionEnergyDetector(LandmarkDetector):
    """Clip-level face and mouth localisation from temporal motion energy.

    The per-pixel mean |frame difference| segments the moving head from
    the background, and inside the head the fast-to-slow motion ratio
    (articulation) peaks at the mouth. One head box and mouth centre per
    clip (or window) give canonical landmarks translated onto the mouth.
    """

    synthesizes_parametric_layout = True

    def __init__(self, keep_mass: float = 0.85, blur: int = 11,
                 center_sigma: float = 0.5, min_box: int = 24,
                 max_diff_frames: int = 64, close_k: int = 25):
        self.keep_mass = keep_mass
        self.blur = blur
        self.center_sigma = center_sigma
        self.min_box = min_box
        self.max_diff_frames = max_diff_frames
        self.close_k = close_k  # morphological-closing kernel

    def motion_map(self, frames: np.ndarray) -> np.ndarray:
        t = len(frames)
        if t < 2:
            return _gradient_energy(frames[0])
        step = max(1, t // self.max_diff_frames)
        f = frames[::step].astype(np.float32, copy=False)
        return _box_blur(np.abs(np.diff(f, axis=0)).mean(axis=0), self.blur)

    def articulation_map(self, frames: np.ndarray) -> np.ndarray:
        """Fast-to-slow temporal-motion ratio: articulation lights up, head
        sway and cast shadows cancel out."""
        f = frames.astype(np.float32, copy=False)
        if len(f) < 8:
            return self.motion_map(frames)
        fast = np.abs(np.diff(f, axis=0)).mean(axis=0)
        lag = min(6, len(f) - 1)
        slow = np.abs(f[lag:] - f[:-lag]).mean(axis=0) / lag
        return _box_blur(fast, self.blur) / (_box_blur(slow, self.blur) + 0.05)

    def detect_clip(self, frames: np.ndarray):
        """The maps (numpy), then the scalar logic."""
        if len(frames) < 2:
            return None
        frames = np.asarray(frames).astype(np.float32, copy=False)
        return self.detect_from_maps(self.motion_map(frames), self.articulation_map(frames))

    def detect_from_maps(self, motion_map: np.ndarray, artic_map: np.ndarray):
        """Host scalar logic over dense [H, W] maps: ``((x0, y0, w, h),
        mouth (x, y), face_w)`` or None."""
        h, w = motion_map.shape
        # mild centre prior against border flicker
        wy = np.exp(-0.5 * ((np.arange(h) - h / 2) / (self.center_sigma * h)) ** 2)
        wx = np.exp(-0.5 * ((np.arange(w) - w / 2) / (self.center_sigma * w)) ** 2)
        mw = motion_map * wy[:, None] * wx[None, :]

        # moving-blob silhouette: a fraction of the peak, closed by a blur
        thresh = (1.0 - self.keep_mass) * mw.max()
        mask = _box_blur((mw > thresh).astype(np.float32), self.close_k) > 0.5
        ys, xs = np.nonzero(mask)
        if len(xs) == 0:
            return None
        x0, x1 = int(xs.min()), int(xs.max()) + 1
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        if (x1 - x0) < self.min_box or (y1 - y0) < self.min_box:
            return None

        # head width: the median silhouette width over the crown rows
        widths = mask.sum(axis=1).astype(np.float32)
        head_rows = np.nonzero(widths > 0.4 * widths.max())[0]
        y_head = int(head_rows.min())
        span = max(int(0.35 * (y1 - y_head)), 10)
        face_w = float(np.median(widths[y_head: y_head + span]))
        face_w = float(np.clip(face_w, self.min_box, x1 - x0))

        # mouth: centroid of the top decile of the articulation map in the
        # head, between 0.55 and 1.35 head widths below the crown
        art = artic_map * mask
        lo_y = int(y_head + 0.55 * face_w)
        hi_y = min(int(y_head + 1.35 * face_w), h)
        sub = art[lo_y:hi_y]
        if sub.size == 0 or sub.max() <= 0:
            return None
        top = sub >= np.percentile(sub[sub > 0], 90) if (sub > 0).any() else sub > 0
        sy, sx = np.nonzero(top)
        weights = sub[sy, sx]
        mouth = (
            float(np.average(sx, weights=weights)),
            float(lo_y + np.average(sy, weights=weights)),
        )
        return (x0, y0, x1 - x0, y1 - y0), mouth, face_w

    def _landmarks_for(self, mouth, face_w) -> np.ndarray:
        # the canonical layout at the measured face width, its mouth centre
        # on the detected mouth
        lms = canonical_landmarks_from_box(0, 0, face_w, face_w * 170.0 / 156.0)
        shift = np.asarray(mouth, np.float32) - lms[48:68].mean(axis=0)
        return lms + shift

    def __call__(self, frames: np.ndarray, window: int = 25) -> List[Optional[np.ndarray]]:
        """One detection per ``window`` frames (the head moves through a
        clip), regularised toward the whole-clip estimate; the window
        centres are interpolated downstream."""
        frames = np.asarray(frames)
        t = len(frames)
        out: List[Optional[np.ndarray]] = [None] * t

        clip_det = self.detect_clip(frames)
        if clip_det is None:
            return out
        _box, clip_mouth, clip_face_w = clip_det

        # window mouths clamped to a plausible radius of their median, at
        # the clip's face scale, so one bad window cannot yank the crop
        est = []  # (centre index, mouth)
        for start in range(0, t, window):
            chunk = frames[start: min(start + window, t)]
            det = self.detect_clip(chunk) if len(chunk) >= 12 else None
            if det is None:
                continue
            est.append((start + len(chunk) // 2, np.asarray(det[1], np.float32)))
        if est:
            mouths = np.stack([m for _, m in est])
            med = np.median(mouths, axis=0)
            # heads turn sideways more than they bob
            max_dev = np.array([0.30, 0.12], np.float32) * clip_face_w
            for (idx, m) in est:
                clamped = med + np.clip(0.7 * (m - med), -max_dev, max_dev)
                out[idx] = self._landmarks_for(clamped, clip_face_w)
        else:
            lms = self._landmarks_for(clip_mouth, clip_face_w)
            out = [lms.copy() for _ in range(t)]
        return out


def _edge_pad_last(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate the first and last element ``pad`` times along the last dim."""
    if pad == 0:
        return a
    shape = a.shape[:-1] + (pad,)
    return torch.cat([a[..., :1].expand(shape), a, a[..., -1:].expand(shape)], dim=-1)


def _box_blur_t(x: torch.Tensor, k: int) -> torch.Tensor:
    """Edge-padded cumulative-sum box blur over the last two dims, rows
    then columns, in float32: the device twin of :func:`_box_blur`, for
    [..., H, W] maps of any leading shape."""
    pad = k // 2

    def smooth(a: torch.Tensor, dim: int) -> torch.Tensor:
        a = _edge_pad_last(a.movedim(dim, -1), pad)
        c = torch.cumsum(a, dim=-1)
        c = torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], dim=-1)
        return ((c[..., k:] - c[..., :-k]) / k).movedim(-1, dim)

    return smooth(smooth(x, -2), -1)


def _device_maps_fn(window: int, blur: int, max_diff_frames: int):
    """A function computing every detection map on the clips' device:
    clips [B, T, H, W] -> (clip_motion [B, H, W], clip_artic [B, H, W],
    win_motion [B, NW, H, W], win_artic [B, NW, H, W]), NW = T // window
    (or the clip maps when T < window). The numpy maps' arithmetic."""

    def maps_of(f):  # f: [..., t, H, W]
        t = f.shape[-3]
        step = max(1, t // max_diff_frames)
        sub = f[..., ::step, :, :]
        motion = _box_blur_t((sub[..., 1:, :, :] - sub[..., :-1, :, :]).abs().mean(dim=-3), blur)
        fast = (f[..., 1:, :, :] - f[..., :-1, :, :]).abs().mean(dim=-3)
        lag = min(6, t - 1)
        slow = (f[..., lag:, :, :] - f[..., :-lag, :, :]).abs().mean(dim=-3) / lag
        artic = _box_blur_t(fast, blur) / (_box_blur_t(slow, blur) + 0.05)
        return motion, artic

    def compute(clips: torch.Tensor):
        clips = clips.float()
        b, t, h, w = clips.shape
        clip_motion, clip_artic = maps_of(clips)
        nw = t // window
        if nw >= 1:
            wins = clips[:, : nw * window].reshape(b, nw, window, h, w)
            win_motion, win_artic = maps_of(wins)
        else:
            win_motion = clip_motion[:, None]
            win_artic = clip_artic[:, None]
        return clip_motion, clip_artic, win_motion, win_artic

    return compute


def _device_detect_fn(keep_mass: float, center_sigma: float, min_box: int, close_k: int = 25):
    """The device translation of ``MotionEnergyDetector.detect_from_maps``,
    batched: (motion_map, artic_map) [..., H, W] -> [..., 4] rows of
    (mouth_x, mouth_y, face_w, ok), with fixed shapes (NaN quantiles and
    boolean reductions in place of numpy's percentile and nonzero)."""

    def detect(motion_map: torch.Tensor, artic_map: torch.Tensor) -> torch.Tensor:
        h, w = motion_map.shape[-2:]
        dev = motion_map.device
        row_ids = torch.arange(h, device=dev)
        col_ids = torch.arange(w, device=dev)
        wy = torch.exp(-0.5 * ((row_ids - h / 2) / (center_sigma * h)) ** 2)
        wx = torch.exp(-0.5 * ((col_ids - w / 2) / (center_sigma * w)) ** 2)
        mw = motion_map * wy[:, None] * wx[None, :]

        thresh = (1.0 - keep_mass) * mw.amax(dim=(-2, -1), keepdim=True)
        mask = _box_blur_t((mw > thresh).float(), close_k) > 0.5

        rows_any = mask.any(dim=-1)
        cols_any = mask.any(dim=-2)
        y0 = torch.where(rows_any, row_ids, h).amin(dim=-1)
        y1 = torch.where(rows_any, row_ids, -1).amax(dim=-1) + 1
        x0 = torch.where(cols_any, col_ids, w).amin(dim=-1)
        x1 = torch.where(cols_any, col_ids, -1).amax(dim=-1) + 1
        ok = mask.any(dim=-1).any(dim=-1) & ((x1 - x0) >= min_box) & ((y1 - y0) >= min_box)

        widths = mask.sum(dim=-1).float()  # [..., H]
        head_rows = widths > 0.4 * widths.amax(dim=-1, keepdim=True)
        y_head = torch.where(head_rows, row_ids, h).amin(dim=-1)
        span = (0.35 * (y1 - y_head)).to(torch.int32).clamp_min(10)
        in_span = (row_ids >= y_head[..., None]) & (row_ids < (y_head + span)[..., None])
        face_w = nanmedian(torch.where(in_span, widths, float("nan")), dim=-1)
        face_w = torch.minimum(face_w.clamp_min(min_box), (x1 - x0).clamp_min(min_box).float())

        lo_y = y_head + 0.55 * face_w
        hi_y = torch.minimum(y_head + 1.35 * face_w, torch.tensor(float(h), device=dev))
        row_band = (row_ids >= lo_y[..., None]) & (row_ids < hi_y[..., None])  # [..., H]
        sub = artic_map * mask * row_band[..., None]
        pos = sub > 0
        q90 = nanquantile(torch.where(pos, sub, float("nan")).flatten(-2), 0.9, dim=-1)
        top = torch.where(sub >= q90[..., None, None], sub, 0.0)
        total = top.sum(dim=(-2, -1))
        yy = row_ids.float()[:, None].expand(h, w)
        xx = col_ids.float()[None, :].expand(h, w)
        mouth_x = (top * xx).sum(dim=(-2, -1)) / total.clamp_min(1e-6)
        mouth_y = (top * yy).sum(dim=(-2, -1)) / total.clamp_min(1e-6)
        ok = ok & (total > 0) & torch.isfinite(face_w)
        return torch.stack([mouth_x, mouth_y, face_w, ok.float()], dim=-1)

    return detect


class BatchedMotionDetector:
    """MotionEnergyDetector over a clip batch with the dense work (temporal
    differences, blurs, articulation ratio) and, with ``device_logic``,
    the detection logic on ``device``; the host assembles the
    window-regularised canonical landmarks per clip, as
    ``MotionEnergyDetector.__call__`` does. ``track`` follows the mouth
    frame by frame with the NCC tracker seeded by the clip estimate."""

    def __init__(self, window: int = 25, downsample: int = 1,
                 device_logic: bool = True, track: bool = False,
                 track_template: int = 40, track_search: int = 20,
                 device: Union[str, torch.device] = "cuda", **kw):
        from avsl_tpu_torch.core.device import resolve_device

        self.window = window
        self.downsample = max(downsample, 1)
        self.device_logic = device_logic
        self.track = track
        self.track_template = track_template
        self.track_search = track_search
        self.device = resolve_device(device)
        self.base = MotionEnergyDetector(**kw)
        self._compute = _device_maps_fn(window, self.base.blur, self.base.max_diff_frames)
        self._detect = _device_detect_fn(
            self.base.keep_mass, self.base.center_sigma, self.base.min_box, self.base.close_k
        )

    def _estimates(self, dev_in: torch.Tensor) -> tuple:
        """-> (clip_det [B, 4], win_det [B, NW, 4]) as numpy."""
        cm, ca, wm, wa = self._compute(dev_in)
        if self.device_logic:
            return self._detect(cm, ca).cpu().numpy(), self._detect(wm, wa).cpu().numpy()
        cm, ca, wm, wa = [x.cpu().numpy() for x in (cm, ca, wm, wa)]
        b, nw = wm.shape[0], wm.shape[1]
        clip_det = np.zeros((b, 4), np.float32)
        win_det = np.zeros((b, nw, 4), np.float32)
        for i in range(b):
            d = self.base.detect_from_maps(cm[i], ca[i])
            if d is not None:
                clip_det[i] = (*d[1], d[2], 1.0)
            for wi in range(nw):
                dw = self.base.detect_from_maps(wm[i, wi], wa[i, wi])
                if dw is not None:
                    win_det[i, wi] = (*dw[1], dw[2], 1.0)
        return clip_det, win_det

    def __call__(self, clips) -> List[List[Optional[np.ndarray]]]:
        """clips [B, T, H, W] (numpy or a tensor) -> per-clip landmark
        lists (length T)."""
        ds = self.downsample
        dev = torch.as_tensor(clips, device=self.device)
        dev_in = dev[:, :, ::ds, ::ds] if ds > 1 else dev
        clip_det, win_det = self._estimates(dev_in)
        b, t = clips.shape[:2]
        nw = win_det.shape[1]

        tracks = None
        if self.track:
            from avsl_tpu_torch.kernels.track import ncc_track_batch

            tracks = ncc_track_batch(
                dev_in, torch.as_tensor(clip_det[:, :2], device=self.device),
                template_size=self.track_template, search=self.track_search,
            ).cpu().numpy()  # [B, T, 2] in downsampled coords

        out: List[List[Optional[np.ndarray]]] = []
        for i in range(b):
            per: List[Optional[np.ndarray]] = [None] * t
            if clip_det[i, 3] < 0.5:
                out.append(per)
                continue
            clip_mouth, clip_face_w = clip_det[i, :2], float(clip_det[i, 2])
            if tracks is not None:
                med = np.median(tracks[i], axis=0)
                max_dev = np.array([0.30, 0.15], np.float32) * clip_face_w
                for fi in range(t):
                    m = med + np.clip(tracks[i, fi] - med, -max_dev, max_dev)
                    per[fi] = self.base._landmarks_for(m * ds, clip_face_w * ds)
                out.append(per)
                continue
            est = []
            for wi in range(nw):
                if win_det[i, wi, 3] >= 0.5:
                    center = min(wi * self.window + self.window // 2, t - 1)
                    est.append((center, win_det[i, wi, :2].astype(np.float32)))
            if est:
                mouths = np.stack([m for _, m in est])
                med = np.median(mouths, axis=0)
                max_dev = np.array([0.30, 0.12], np.float32) * clip_face_w
                for (idx, m) in est:
                    clamped = med + np.clip(0.7 * (m - med), -max_dev, max_dev)
                    per[idx] = self.base._landmarks_for(clamped * ds, clip_face_w * ds)
            else:
                lms = self.base._landmarks_for(clip_mouth * ds, clip_face_w * ds)
                per = [lms.copy() for _ in range(t)]
            out.append(per)
        return out


# the CNN regressor: five 3x3 stride-2 convolutions (flax 'SAME' padding),
# a ReLU after each, then Dense 256, ReLU, Dense 136 and a sigmoid
CNN_FEATURES = (16, 32, 64, 128, 128)
CNN_INPUT = 128
# flax module names of the layers, in order, and the port's
_FLAX_CNN_LAYERS = tuple(f"Conv_{i}" for i in range(len(CNN_FEATURES))) + ("Dense_0", "Dense_1")
_TORCH_CNN_LAYERS = tuple(f"convs.{i}" for i in range(len(CNN_FEATURES))) + ("dense_0", "dense_1")


def _same_pad(size: int, kernel: int = 3, stride: int = 2):
    """XLA's 'SAME' padding of one axis, (before, after): the odd unit goes
    after, so a stride-2 3x3 convolution of an even side pads (0, 1)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class LandmarkNet(nn.Module):
    """The CNN landmark regressor (JAX ``landmark_net``'s module):
    [B, 128, 128, 1] grey levels in [0, 1], NHWC as the flax module takes
    them -> [B, 68, 2] (x, y) in [0, 1]. Each convolution pads as flax's
    'SAME' does (see :func:`_same_pad`), and the [B, 4, 4, 128] features
    are flattened in flax's NHWC order before ``dense_0``."""

    def __init__(self, device=None):
        super().__init__()
        chans = (1,) + CNN_FEATURES
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2, device=device)
                                   for a, b in zip(chans, chans[1:]))
        side = CNN_INPUT // 2 ** len(CNN_FEATURES)
        self.dense_0 = nn.Linear(CNN_FEATURES[-1] * side * side, 256, device=device)
        self.dense_1 = nn.Linear(256, 136, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.dense_1(F.relu(self.dense_0(x)))
        return torch.sigmoid(x).reshape(-1, 68, 2)


@torch.no_grad()
def landmark_net(device: Union[str, torch.device] = "cuda", seed: int = 0) -> LandmarkNet:
    """A :class:`LandmarkNet` on ``device`` with random weights from a
    generator seeded with ``seed``: fan-in-scaled normal kernels (flax's
    lecun-normal scale, not its draw) and zero biases."""
    from avsl_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    net = LandmarkNet(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name in _TORCH_CNN_LAYERS:
        layer = net.get_submodule(name)
        layer.weight.normal_(0.0, 1.0 / float(np.sqrt(layer.weight[0].numel())), generator=gen)
        layer.bias.zero_()
    return net


def cnn_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``landmark_net`` param tree (numpy or jax leaves, with or
    without the ``params`` level) -> the fp32 state dict of
    :class:`LandmarkNet`: conv kernels [kh, kw, in, out] to [out, in, kh,
    kw], dense kernels [in, out] to [out, in]."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for flax_name, name in zip(_FLAX_CNN_LAYERS, _TORCH_CNN_LAYERS):
        kernel = np.asarray(tree[flax_name]["kernel"], np.float32)
        kernel = kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(tree[flax_name]["bias"], np.float32))
    return sd


def cnn_state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """The inverse of :func:`cnn_state_dict_from_flax`: ``{"params":
    {"Conv_0": {"kernel", "bias"}, ..., "Dense_1": {...}}}`` of fp32 numpy
    arrays, the tree ``landmark_net().apply`` takes."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for flax_name, name in zip(_FLAX_CNN_LAYERS, _TORCH_CNN_LAYERS):
        weight = state_dict[f"{name}.weight"].detach().cpu().float().numpy()
        kernel = weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T
        out[flax_name] = {"kernel": np.ascontiguousarray(kernel),
                          "bias": state_dict[f"{name}.bias"].detach().cpu().float().numpy()}
    return {"params": out}


DEFAULT_CNN_WEIGHTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets", "landmark_cnn.npz"
)


def save_cnn_params(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Save :class:`LandmarkNet` weights as the JAX package's flat ``.npz``
    (flax's "/"-joined keys, ``params/Conv_0/kernel`` ...
    ``params/Dense_1/bias``, in flax's layouts): a plain-array format
    with no code-execution surface (unlike pickle), which either package
    loads."""
    flat = {f"params/{layer}/{leaf}": value
            for layer, leaves in cnn_state_dict_to_flax(state_dict)["params"].items()
            for leaf, value in leaves.items()}
    np.savez_compressed(path, **flat)


def load_cnn_params(path: str) -> Dict[str, torch.Tensor]:
    """Load a flat ``.npz`` weight file (either package's) as the state
    dict of :class:`LandmarkNet`."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return cnn_state_dict_from_flax(tree)


class CNNLandmarkDetector(LandmarkDetector):
    """Conv landmark regressor batched over the clip (one forward on
    ``device``).

    Loads the synthetic-face-pretrained weights shipped under
    data/assets/landmark_cnn.npz when present (train with
    ``python -m avsl_tpu_torch.cli.train_landmarks``), else ``weights_path``
    or ``params`` (a state dict); random weights from ``seed`` otherwise.

    Documented departure: the JAX detector resizes every frame to 128 x
    128 with ``cv2.resize``; here frames that are already 128 x 128 are
    not resized (OpenCV's resize to the same size is the identity), so
    such clips need no OpenCV, which a card's host may lack. Frames are
    cast to uint8 first, as in JAX.
    """

    INPUT = CNN_INPUT

    def __init__(self, params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 weights_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.net = landmark_net(device, seed).eval()
        self.device = next(self.net.parameters()).device
        if params is None:
            path = weights_path or (
                DEFAULT_CNN_WEIGHTS if os.path.exists(DEFAULT_CNN_WEIGHTS) else None
            )
            if path:
                params = load_cnn_params(path)
        if params is not None:
            self.net.load_state_dict(params)

    def load_params(self, path: str) -> None:
        self.net.load_state_dict(load_cnn_params(path))

    @torch.no_grad()
    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        t, h, w = frames.shape
        frames = frames.astype(np.uint8)
        if (h, w) != (self.INPUT, self.INPUT):
            import cv2

            frames = np.stack([cv2.resize(f, (self.INPUT, self.INPUT)) for f in frames])
        x = torch.from_numpy(frames).to(self.device, torch.float32)[..., None] / 255.0
        norm = self.net(x).cpu().numpy()  # [T, 68, 2] in [0, 1]
        scaled = norm * np.array([w, h], np.float32)
        return [scaled[i] for i in range(t)]


class AnchorTrackDetector(LandmarkDetector):
    """Mid-clip anchor and bidirectional NCC mouth tracking (OpenCV).

    A ``base`` detector gives the coarse layout and scale; a mouth-centred
    template is cut at the detection nearest the clip's middle and tracked
    (fixed template, so no drift; the search window follows the previous
    frame) back to the first frame and on to the last. The output is the
    canonical layout (or ``layout``) at the base detector's scale on the
    tracked mouth centre per frame.
    """

    def __init__(self, base: Optional[LandmarkDetector] = None,
                 template: int = 48, search: int = 28,
                 min_corr: float = 0.3,
                 layout: Optional[np.ndarray] = None):
        self.base = base or EnergyBoxDetector()
        self.template = template
        self.search = search
        self.min_corr = min_corr
        # the layout the emitted landmarks are an affine image of; it must
        # match the warp's mean face (default: the parametric face)
        self.layout = None if layout is None else np.asarray(layout, np.float64)
        self.synthesizes_parametric_layout = layout is None

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        import cv2

        base_lms = self.base(frames)
        valid = [i for i, l in enumerate(base_lms) if l is not None]
        if not valid:
            return base_lms
        t_total, h, w = frames.shape[:3]
        anchor = min(valid, key=lambda i: abs(i - t_total // 2))
        lm_a = base_lms[anchor]
        mouth_a = lm_a[48:68].mean(axis=0)
        # scale from the outer-eye span (36 <-> 45) of the base layout
        canon = self.layout if self.layout is not None else canonical_mean_face(300).astype(np.float64)
        canon_mouth = canon[48:68].mean(axis=0)
        eye_span = canon[45, 0] - canon[36, 0]
        s = (lm_a[45, 0] - lm_a[36, 0]) / eye_span

        half_t = self.template // 2
        cx = int(np.clip(mouth_a[0], half_t, w - half_t))
        cy = int(np.clip(mouth_a[1], half_t, h - half_t))
        tmpl = frames[anchor][cy - half_t: cy + half_t, cx - half_t: cx + half_t].astype(np.float32)

        centers = np.zeros((t_total, 2), np.float32)
        centers[anchor] = (cx, cy)

        def track(order):
            px, py = float(cx), float(cy)
            for i in order:
                x0 = int(np.clip(px - half_t - self.search, 0, w - 1))
                y0 = int(np.clip(py - half_t - self.search, 0, h - 1))
                x1 = int(np.clip(px + half_t + self.search, 1, w))
                y1 = int(np.clip(py + half_t + self.search, 1, h))
                win = frames[i][y0:y1, x0:x1].astype(np.float32)
                if win.shape[0] <= self.template or win.shape[1] <= self.template:
                    centers[i] = (px, py)
                    continue
                res = cv2.matchTemplate(win, tmpl, cv2.TM_CCOEFF_NORMED)
                _, mx, _, loc = cv2.minMaxLoc(res)
                if mx >= self.min_corr:
                    px = x0 + loc[0] + half_t
                    py = y0 + loc[1] + half_t
                centers[i] = (px, py)

        track(range(anchor - 1, -1, -1))
        track(range(anchor + 1, t_total))

        offset = s * (canon - canon_mouth)
        return [(offset + centers[i][None]).astype(np.float32) for i in range(t_total)]


class PrecomputedLandmarks(LandmarkDetector):
    def __init__(self, landmarks: Sequence[Optional[np.ndarray]]):
        self.landmarks = list(landmarks)

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        assert len(self.landmarks) >= len(frames)
        return self.landmarks[: len(frames)]


def create_detector(kind: str = "energy", **kw) -> LandmarkDetector:
    """Detector factory by name: ``motion``, ``energy``, ``cnn``,
    ``anchor_track`` or ``refined``."""
    if kind == "motion":
        return MotionEnergyDetector(**kw)
    if kind == "energy":
        return EnergyBoxDetector(**kw)
    if kind == "cnn":
        return CNNLandmarkDetector(**kw)
    if kind == "anchor_track":
        return AnchorTrackDetector(**kw)
    if kind == "refined":
        from avsl_tpu_torch.data.lip_refine import RefinedMouthTracker

        return RefinedMouthTracker(**kw)
    raise ValueError(f"Unknown detector kind {kind!r}")
