"""The on-device lip-ROI frontend: raw closeups -> 96x96 mouth crops.

Port of ``avsl_tpu/kernels/lip_pipeline.py``. Motion and articulation
maps, the scalar face and mouth detection, the mouth-trajectory synthesis
(the device twin of ``BatchedMotionDetector`` + ``landmarks_interpolate`` +
``smooth_landmarks``) and the separable warp run on the clips' device; the
host uploads uint8 clips and gets crops (or whatever the model makes of
them) back. The synthesized landmarks are an affine image of the
canonical layout,

    lms[t] = s * (canon - canon_mouth_center) + mouth_traj[t],   s = face_w / 156

so interpolating and smoothing the 68-point field reduces to the 2-D mouth
trajectory, and the separable warp's coordinates follow from (traj,
face_w) in closed form (``coords_from_traj``). Functions are batched over
clips: [B, ...] in, [B, ...] out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from avsl_tpu_torch.kernels.stats import median, nanmedian

# the canonical face box inside the 300x300 layout (canonical_landmarks_from_box)
_CANON_X0, _CANON_Y0, _CANON_W, _CANON_H = 72.0, 100.0, 156.0, 170.0


def canonical_mean_face(size: int = 300) -> np.ndarray:
    """``data.lip_roi.canonical_mean_face``, imported late: the data package
    imports this one."""
    from avsl_tpu_torch.data.lip_roi import canonical_mean_face as _cmf

    return _cmf(size)


def masked_time_interp(values: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
                       t: int) -> torch.Tensor:
    """Linear interpolation of sparse window estimates onto ``t`` frames.

    ``values`` [..., NW, D], ``valid`` [..., NW] bool, ``centers`` [NW]
    frame indices (shared by the batch). Linear between consecutive valid
    estimates, edge fill outside; centres that repeat (clamped to t-1) are
    averaged. Assumes a valid entry (callers mask the no-detection case).
    Returns [..., t, D]."""
    lead = values.shape[:-2]
    d = values.shape[-1]
    dev = values.device
    centers = centers.long()
    safe_vals = torch.where(valid[..., None], values, 0.0)
    grid_val = values.new_zeros(lead + (t, d)).index_add_(-2, centers, safe_vals)
    counts = values.new_zeros(lead + (t,)).index_add_(-1, centers, valid.float())
    grid_has = counts > 0
    grid_val = grid_val / counts.clamp_min(1.0)[..., None]

    idx = torch.arange(t, device=dev)
    ff = torch.cummax(torch.where(grid_has, idx, -1), dim=-1).values  # previous valid index
    bf = torch.cummin(torch.where(grid_has, idx, t).flip(-1), dim=-1).values.flip(-1)  # next one
    prev = torch.where(ff >= 0, ff, bf).clamp(0, t - 1)
    nxt = torch.where(bf < t, bf, ff).clamp(0, t - 1)
    span = (nxt - prev).clamp_min(1)
    w = ((idx - prev) / span).clamp(0.0, 1.0)
    at = lambda i: torch.gather(grid_val, -2, i[..., None].expand(i.shape + (d,)))  # noqa: E731
    return (1.0 - w)[..., None] * at(prev) + w[..., None] * at(nxt)


def smooth_time(x: torch.Tensor, window: int = 12, dim: int = 0) -> torch.Tensor:
    """Clamped-edge sliding mean along ``dim`` with a min(t, window)
    window: the device twin of ``lip_roi.smooth_landmarks`` (float32
    prefix sums)."""
    x = x.movedim(dim, 0)
    t = x.shape[0]
    win = min(t, window)
    half = win // 2
    c = torch.cat([torch.zeros_like(x[:1]), torch.cumsum(x, dim=0)])
    idx = torch.arange(t, device=x.device)
    lo = (idx - half).clamp_min(0)
    hi = (idx + half + 1).clamp_max(t)
    shape = (-1,) + (1,) * (x.dim() - 1)
    out = (c[hi] - c[lo]) / (hi - lo).to(x.dtype).reshape(shape)
    return out.movedim(0, dim)


def synthesize_traj(clip_det: torch.Tensor, win_det: torch.Tensor, t: int, window: int = 25,
                    detect_ds: int = 1, smoothing_window: int = 12):
    """The device twin of ``BatchedMotionDetector.__call__`` (without
    tracking), interpolation and smoothing, in trajectory form.

    ``clip_det`` [..., 4] and ``win_det`` [..., NW, 4] rows of (mouth_x,
    mouth_y, face_w, ok) in detection coordinates. Returns ``(traj [..., t,
    2], face_w [...], ok [...] bool)`` at full resolution: the smoothed
    mouth-centre trajectory, the face width and whether the clip-level
    detection succeeded; a failed one falls back to the canonical layout."""
    dev = clip_det.device
    canon = torch.as_tensor(canonical_mean_face(300), dtype=torch.float32, device=dev)
    canon_mouth = canon[48:68].mean(dim=0)  # ~(150, 218)

    nw = win_det.shape[-2]
    clip_ok = clip_det[..., 3] >= 0.5
    face_w_det = clip_det[..., 2]

    valid = win_det[..., 3] >= 0.5
    mouths = win_det[..., :2]  # detection coordinates
    med = nanmedian(torch.where(valid[..., None], mouths, float("nan")), dim=-2)  # [..., 2]
    med = torch.where(torch.isfinite(med), med, clip_det[..., :2])
    max_dev = torch.tensor([0.30, 0.12], dtype=torch.float32, device=dev) * face_w_det[..., None]
    dev_lim = max_dev[..., None, :]
    clamped = med[..., None, :] + torch.clamp(0.7 * (mouths - med[..., None, :]), -dev_lim, dev_lim)

    centers = (torch.arange(nw, device=dev) * window + window // 2).clamp_max(t - 1)
    traj = masked_time_interp(clamped, valid, centers, t)  # [..., t, 2]
    traj = torch.where(valid.any(dim=-1)[..., None, None], traj, clip_det[..., None, :2])

    # full-resolution coordinates; a failed detection takes the canonical layout
    traj = torch.where(clip_ok[..., None, None], traj * detect_ds, canon_mouth)
    face_w = torch.where(clip_ok, face_w_det * detect_ds, _CANON_W)
    traj = smooth_time(traj, smoothing_window, dim=-2)
    return traj, face_w, clip_ok


def synthesize_landmarks(clip_det: torch.Tensor, win_det: torch.Tensor, t: int, window: int = 25,
                         detect_ds: int = 1, smoothing_window: int = 12) -> torch.Tensor:
    """Landmarks [..., t, 68, 2]: :func:`synthesize_traj` expanded through
    ``lms[t] = s * (canon - cm) + traj[t]``."""
    canon = torch.as_tensor(canonical_mean_face(300), dtype=torch.float32, device=clip_det.device)
    canon_mouth = canon[48:68].mean(dim=0)
    traj, face_w, _ok = synthesize_traj(clip_det, win_det, t, window=window, detect_ds=detect_ds,
                                        smoothing_window=smoothing_window)
    s = (face_w / _CANON_W)[..., None, None, None]
    return s * (canon - canon_mouth) + traj[..., :, None, :]


def _detector(window: int, detector_kw: Optional[dict]):
    """(maps function, batched detect function) of the motion detector."""
    from avsl_tpu_torch.data.landmarks import (
        MotionEnergyDetector,
        _device_detect_fn,
        _device_maps_fn,
    )

    base = MotionEnergyDetector(**(detector_kw or {}))
    return (_device_maps_fn(window, base.blur, base.max_diff_frames),
            _device_detect_fn(base.keep_mass, base.center_sigma, base.min_box, base.close_k))


def make_lip_frontend(
    t: int,
    window: int = 25,
    detect_ds: int = 2,
    crop_size: int = 96,
    out_size: int = 300,
    smoothing_window: int = 12,
    roi: Optional[int] = 144,
    detector_kw: Optional[dict] = None,
):
    """The fused clips -> crops function: clips_u8 [B, t, H, W] uint8 ->
    lip crops [B, t, crop, crop] float32 (0..255 scale) on the clips'
    device.

    ``roi``: the side of the mouth window cut around each clip's median
    mouth before the warp (the warp then works on [B, t, roi, roi], not
    whole frames); None warps whole frames."""
    from avsl_tpu_torch.kernels.warp import warp_and_crop_clip_separable

    compute_maps, detect = _detector(window, detector_kw)
    mean_face_np = canonical_mean_face(out_size)

    def roi_slice(frames, lms):
        h, w = frames.shape[-2:]
        mouth = lms[:, :, 48:68].mean(dim=2)  # [B, t, 2]
        c = median(mouth, dim=1)  # [B, 2]
        x0 = (c[:, 0] - roi / 2).clamp(0, w - roi).to(torch.int32).tolist()
        y0 = (c[:, 1] - roi / 2).clamp(0, h - roi).to(torch.int32).tolist()
        frames = torch.stack([f[:, y: y + roi, x: x + roi] for f, x, y in zip(frames, x0, y0)])
        off = torch.tensor(list(zip(x0, y0)), dtype=torch.float32, device=lms.device)
        return frames, lms - off[:, None, None, :]

    def frontend(clips_u8: torch.Tensor) -> torch.Tensor:
        small = clips_u8[:, :, ::detect_ds, ::detect_ds].float()
        cm, ca, wm, wa = compute_maps(small)
        lms = synthesize_landmarks(detect(cm, ca), detect(wm, wa), t, window=window,
                                   detect_ds=detect_ds, smoothing_window=smoothing_window)
        frames = clips_u8
        if roi is not None:
            frames, lms = roi_slice(frames, lms)
        mean_face = torch.as_tensor(mean_face_np, device=clips_u8.device)
        return warp_and_crop_clip_separable(frames, lms, mean_face, out_size=out_size,
                                            crop_size=crop_size)

    return frontend


def make_staged_lip_frontend(
    t: int,
    window: int = 25,
    detect_ds: int = 2,
    crop_size: int = 96,
    out_size: int = 300,
    smoothing_window: int = 12,
    detector_kw: Optional[dict] = None,
):
    """The lip frontend as separate stages (a dict of functions), each
    running on its inputs' device:

    * ``subsample(clips_u8)`` -> detection stream [B, t, H/ds, W/ds] f32
    * ``landmarks(small)`` -> [B, t, 68, 2] full-resolution landmarks
    * ``traj(small)`` -> (traj [B, t, 2], face_w [B], ok [B])
    * ``track_refine(small, traj, face_w, ok)`` / ``track_refine_parallel``
      -> the same, the trajectory refined by anchored NCC tracking
    * ``traj_tracked(small)`` -> ``track_refine(small, *traj(small))``
    * ``coords_from_traj(traj, face_w, x0=None, y0=None)`` -> (ys, xs)
    * ``traj_window(traj, h, w, roi)`` / ``crop_window(lms, h, w, roi)``
      -> (x0, y0) int32 [B] offsets of a mouth-centred ``roi``² window
    * ``shift(lms, x0, y0)`` -> landmarks in window coordinates
    * ``coords(lms)`` -> (ys, xs) separable sampling coordinates
    * ``sample(frames, ys, xs)`` -> [B, t, crop, crop] f32 lip crops
    * ``warp(frames, lms)`` -> ``sample(frames, *coords(lms))``
    """
    from avsl_tpu_torch.kernels.track import (
        ncc_track_batch_anchored,
        ncc_track_batch_parallel,
    )
    from avsl_tpu_torch.kernels.warp import (
        sample_separable,
        separable_crop_coords,
        warp_and_crop_clip_separable,
    )

    compute_maps, detect = _detector(window, detector_kw)
    mean_face_np = canonical_mean_face(out_size)

    def subsample(clips_u8):
        return clips_u8[:, :, ::detect_ds, ::detect_ds].float()

    def detections(small):
        cm, ca, wm, wa = compute_maps(small)
        return detect(cm, ca), detect(wm, wa)

    def landmarks(small):
        return synthesize_landmarks(*detections(small), t, window=window, detect_ds=detect_ds,
                                    smoothing_window=smoothing_window)

    def traj(small):
        return synthesize_traj(*detections(small), t, window=window, detect_ds=detect_ds,
                               smoothing_window=smoothing_window)

    def _refined(track, base_traj, face_w, det_ok):
        tracked = smooth_time(track * detect_ds, smoothing_window, dim=1)
        # the detection trajectory stays where the detection failed
        return torch.where(det_ok.bool()[:, None, None], tracked, base_traj), face_w, det_ok

    def track_refine(small, base_traj, face_w, det_ok):
        """The detection trajectory refined by mid-clip-anchored
        bidirectional NCC tracking (the device twin of
        ``data.landmarks.AnchorTrackDetector``): the trajectory at t // 2
        seeds the anchor, and its fixed template is tracked to both ends of
        the clip, following fast early-clip motion that the window
        estimates smooth away."""
        anchor = t // 2
        track = ncc_track_batch_anchored(
            small, base_traj[:, anchor, :] / detect_ds, anchor,
            template_size=max(16, 48 // detect_ds), search=max(8, 24 // detect_ds),
        )
        return _refined(track, base_traj, face_w, det_ok)

    def track_refine_parallel(small, base_traj, face_w, det_ok):
        """``track_refine`` with every frame matched on its own inside one
        static search window (``kernels.track.ncc_track_batch_parallel``);
        the radius covers a clip's whole mouth travel."""
        anchor = t // 2
        track = ncc_track_batch_parallel(
            small, base_traj[:, anchor, :] / detect_ds, anchor,
            template_size=max(16, 48 // detect_ds), search=max(24, 96 // detect_ds),
        )
        return _refined(track, base_traj, face_w, det_ok)

    def traj_tracked(small):
        return track_refine(small, *traj(small))

    # the crop-window centre in warped space is the canonical mouth centre,
    # with the clamp and int32 truncation of the landmark path
    cm_x, cm_y = [float(v) for v in mean_face_np[48:68].mean(axis=0)]
    half = crop_size // 2
    cx = int(np.clip(np.float32(cm_x), half, out_size - half))
    cy = int(np.clip(np.float32(cm_y), half, out_size - half))

    def coords_from_traj(traj_bt2, face_w, x0=None, y0=None):
        """Closed-form separable coordinates from (traj, face_w): for the
        synthesized landmarks ``s * (canon - cm) + traj`` the similarity
        fit collapses to ``xs[j] = s * (j + cx - half - cm_x) + traj_x``
        (ys alike). ``x0``/``y0``: per-clip [B] offsets when the frames to
        sample are windows of the full frame."""
        s = (face_w / _CANON_W)[:, None, None]  # [B, 1, 1]
        j = torch.arange(crop_size, dtype=torch.float32, device=traj_bt2.device)
        xs = s * (j + (cx - half) - cm_x) + traj_bt2[..., 0:1]
        ys = s * (j + (cy - half) - cm_y) + traj_bt2[..., 1:2]
        if x0 is not None:
            xs = xs - x0.float()[:, None, None]
            ys = ys - y0.float()[:, None, None]
        return ys, xs

    def _window(c, h: int, w: int, roi: int):
        x0 = (c[:, 0] - roi / 2).clamp(0, w - roi).to(torch.int32)
        y0 = (c[:, 1] - roi / 2).clamp(0, h - roi).to(torch.int32)
        return x0, y0

    def traj_window(traj_bt2, h: int, w: int, roi: int):
        """Mouth-window offsets from the trajectory (its clip median)."""
        return _window(median(traj_bt2, dim=1), h, w, roi)

    def crop_window(lms, h: int, w: int, roi: int):
        return _window(median(lms[:, :, 48:68].mean(dim=2), dim=1), h, w, roi)

    def shift(lms, x0, y0):
        off = torch.stack([x0.float(), y0.float()], dim=-1)
        return lms - off[:, None, None, :]

    def _mean_face(like):
        return torch.as_tensor(mean_face_np, device=like.device)

    def coords(lms):
        return separable_crop_coords(lms, _mean_face(lms), out_size=out_size, crop_size=crop_size)

    def warp(frames, lms):
        return warp_and_crop_clip_separable(frames, lms, _mean_face(lms), out_size=out_size,
                                            crop_size=crop_size)

    return {
        "subsample": subsample,
        "landmarks": landmarks,
        "traj": traj,
        "track_refine": track_refine,
        "track_refine_parallel": track_refine_parallel,
        "traj_tracked": traj_tracked,
        "coords_from_traj": coords_from_traj,
        "traj_window": traj_window,
        "crop_window": crop_window,
        "shift": shift,
        "coords": coords,
        "sample": sample_separable,
        "warp": warp,
    }
