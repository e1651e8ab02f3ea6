"""Lip crops made next to the decoder: clips -> 96x96 mouth crops.

Port of ``avsl_tpu/infer/host_crops.py``. Detection and tracking run on
the host, so only crops (96 * 96 * T uint8, about 11x fewer bytes than the
frames) need to reach the model:

* clip-level detection: :class:`~avsl_tpu_torch.data.landmarks.
  MotionEnergyDetector` on a ``detect_ds``-subsampled stream;
* ``mode="track"`` (default): the anchored parallel NCC tracker, one
  batched call (``cpp/avsl_track`` through
  :mod:`avsl_tpu_torch.kernels.track_native`, or the numpy/OpenCV twin in
  :mod:`avsl_tpu_torch.data.track_host`), smoothed over 12 frames;
* ``mode="interp"``: per-window detection, ``landmarks_interpolate`` and
  ``smooth_landmarks``;
* the warp: closed-form coordinates (``separable_crop_coords_np``), then
  the separable sampler on ``device``, the card by default
  (:func:`~avsl_tpu_torch.kernels.warp.sample_separable`); on the CPU the
  threaded ``cpp/avsl_warp`` sampler (numpy when it is not built), as the
  JAX package samples.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from avsl_tpu_torch.core.device import resolve_device
from avsl_tpu_torch.data.landmarks import LandmarkDetector, MotionEnergyDetector
from avsl_tpu_torch.data.lip_roi import (
    canonical_mean_face,
    landmarks_interpolate,
    layout_face_width,
    relayout_landmarks,
    smooth_landmarks,
)
from avsl_tpu_torch.kernels.track_native import ncc_track_batch_host
from avsl_tpu_torch.kernels.warp import separable_crop_coords_np


class HostLipCropper:
    """clips [B, T, H, W] uint8 -> (crops [B, T, c, c] uint8, ok [B]).

    ``detect_ds``: spatial subsampling of the clip-level detection;
    ``track_ds``: of the per-frame tracker (mode "track");
    ``track_stride``: track every k-th frame and interpolate. ``emit``:
    ``"96"`` (the dataset contract) or ``"88"`` (the eval centre crop,
    applied to the coordinates). A failed detection falls back to the
    canonical layout, as the device frontend does, with ``ok[b] = False``.
    ``device``: where the warp samples.
    """

    def __init__(
        self,
        detect_ds: int = 4,
        detect_stride: int = 2,
        track_ds: int = 2,
        track_stride: int = 1,
        track_top_k: int = 3,
        mode: str = "track",
        crop_size: int = 96,
        out_size: int = 300,
        smoothing_window: int = 12,
        window: int = 25,
        emit: str = "96",
        detector: Optional[LandmarkDetector] = None,
        mean_face: Optional[np.ndarray] = None,
        detector_kw: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if emit not in ("96", "88"):
            raise ValueError(f"emit must be '96' or '88', got {emit!r}")
        if mode not in ("track", "interp"):
            raise ValueError(f"mode must be 'track' or 'interp', got {mode!r}")
        self.device = resolve_device(device)
        self.detect_ds = max(int(detect_ds), 1)
        self.detect_stride = max(int(detect_stride), 1)
        self.track_ds = max(int(track_ds), 1)
        self.track_stride = max(int(track_stride), 1)
        self.track_top_k = max(int(track_top_k), 1)
        self.mode = mode
        self.crop_size = crop_size
        self.out_size = out_size
        self.smoothing_window = smoothing_window
        self.window = window
        self.emit = emit
        self.detector = detector or MotionEnergyDetector(**(detector_kw or {}))
        self.mean_face = (
            canonical_mean_face(out_size) if mean_face is None
            else np.asarray(mean_face, np.float32)
        )
        # landmark synthesis uses the warp's mean face as its layout: the two
        # must be the same geometry (lip_roi.layout_face_width)
        self._canon = self.mean_face.astype(np.float32)
        self._canon_mouth = self._canon[48:68].mean(axis=0)
        self._layout_w = layout_face_width(self._canon)
        # interp mode warps what self.detector emits: parametric-layout
        # output is re-expressed in a custom mean face's layout first
        self._relayout_interp = mean_face is not None and getattr(
            self.detector, "synthesizes_parametric_layout", False
        )

    # ---- trajectory estimation -------------------------------------

    def _lms_from_traj(self, traj: np.ndarray, face_w: float) -> np.ndarray:
        """[T, 2] mouth trajectory -> [T, 68, 2]: lms[t] = s * (layout -
        layout_mouth) + traj[t], s anchored on the layout's jaw span."""
        s = face_w / self._layout_w
        return (s * (self._canon - self._canon_mouth)[None] + traj[:, None, :]).astype(np.float32)

    def _landmarks_track(self, clips: np.ndarray):
        b, t = clips.shape[:2]
        dds, tds = self.detect_ds, self.track_ds
        out = np.empty((b, t, 68, 2), np.float32)
        ok = np.zeros((b,), bool)
        anchor = t // 2
        half_w = self.window // 2
        det = self.detector
        if not isinstance(det, MotionEnergyDetector):
            raise ValueError("mode='track' needs a MotionEnergyDetector")
        # phase 1: per-clip detection at detect_ds, temporally strided
        # (anchor positions and face scales for one batched tracker call)
        anchor_pos = np.zeros((b, 2), np.float32)
        face_ws = np.zeros((b,), np.float32)
        for i in range(b):
            clip_det = det.detect_clip(clips[i, ::self.detect_stride, ::dds, ::dds])
            if clip_det is None:
                out[i] = self._canon[None]
                continue
            _box, clip_mouth, face_w = clip_det
            # the anchor from the mid-clip window at tracker resolution
            mid = det.detect_clip(clips[i, max(0, anchor - half_w): anchor + half_w + 1, ::tds, ::tds])
            if mid is not None:
                anchor_pos[i] = np.asarray(mid[1], np.float32)
            else:
                anchor_pos[i] = np.asarray(clip_mouth, np.float32) * dds / tds
            face_ws[i] = float(face_w) * dds
            ok[i] = True
        if not ok.any():
            return out, ok
        # phase 2: one batched NCC tracking call over the detected clips
        sel = np.nonzero(ok)[0]
        tracks, trk_ok = ncc_track_batch_host(
            clips[sel], anchor_pos[sel], anchor, ds=tds,
            template_size=max(16, 48 // tds), search=max(24, 96 // tds),
            stride=self.track_stride, top_k=self.track_top_k,
        )
        # phase 3: smoothing and landmark synthesis
        for j, i in enumerate(sel):
            if not trk_ok[j]:
                out[i] = self._canon[None]
                ok[i] = False
                continue
            traj = smooth_landmarks(tracks[j] * tds, self.smoothing_window)
            out[i] = self._lms_from_traj(traj, face_ws[i])
        return out, ok

    def _landmarks_interp(self, clips: np.ndarray):
        b, t = clips.shape[:2]
        ds = self.detect_ds
        out = np.empty((b, t, 68, 2), np.float32)
        ok = np.zeros((b,), bool)
        for i in range(b):
            small = clips[i, :, ::ds, ::ds]
            if isinstance(self.detector, MotionEnergyDetector):
                sparse = self.detector(small, window=self.window)
            else:
                sparse = self.detector(small)
            sparse = [(l * ds if l is not None else None) for l in sparse]
            lms = landmarks_interpolate(sparse)
            if lms is None:
                out[i] = self._canon[None]
                continue
            lms = smooth_landmarks(lms, self.smoothing_window)
            if self._relayout_interp:
                lms = relayout_landmarks(lms, self._canon)
            out[i] = lms
            ok[i] = True
        return out, ok

    def landmarks(self, clips: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[B, T, H, W] -> (lms [B, T, 68, 2] full-res, ok [B] bool)."""
        if self.mode == "track":
            return self._landmarks_track(clips)
        return self._landmarks_interp(clips)

    # ---- warp --------------------------------------------------------

    def coords(self, lms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Separable sampling coordinates for full-resolution frames."""
        ys, xs = separable_crop_coords_np(lms, self.mean_face, out_size=self.out_size,
                                          crop_size=self.crop_size)
        if self.emit == "88":
            # the eval centre crop (96 -> 88) in coordinate space
            off = (self.crop_size - 88) // 2
            ys = ys[..., off: off + 88]
            xs = xs[..., off: off + 88]
        return ys, xs

    def __call__(self, clips: np.ndarray, n_threads: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        clips = np.asarray(clips)
        if clips.ndim != 4:
            raise ValueError(f"expected [B, T, H, W], got {clips.shape}")
        lms, ok = self.landmarks(clips)
        ys, xs = self.coords(lms)
        if self.device.type == "cpu":
            from avsl_tpu_torch.kernels.warp_native import sample_separable_host

            return sample_separable_host(clips, ys, xs, out_dtype=np.uint8, n_threads=n_threads), ok
        from avsl_tpu_torch.kernels.warp import sample_separable

        crops = sample_separable(torch.as_tensor(clips, device=self.device),
                                 torch.as_tensor(ys, device=self.device),
                                 torch.as_tensor(xs, device=self.device))
        return crops.clamp(0, 255).to(torch.uint8).cpu().numpy(), ok
