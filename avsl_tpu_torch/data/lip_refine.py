"""Refined mouth tracking: per-frame lip localisation and absolute scale.

Port of ``avsl_tpu/data/lip_refine.py``, host numpy and OpenCV, the
landmark detector of the default ``raw_lip_mode="host_refined"`` serving
mode (the offline preprocessing's own, so a segment gets the same crop at
serving time as at training-data time):

* **Skin-run scale** (:func:`face_width_at`, :func:`skin_reference`): the
  face width at the cheek band is the gap-tolerant run of skin-toned
  pixels through the mouth centre, against a clip-median skin reference;
  the canonical face is 120 units wide at mouth height, which gives the
  canonical-to-raw scale per frame.
* **Sandwich lip-line scan** (:func:`sandwich_y_candidates`,
  :func:`sandwich_best_x`): the inter-lip line is the darkness maximum
  with a bright philtrum about 0.2 face widths above and a bright chin
  below, which tells it from the chin crease and the nose shadow; the same
  response scanned over x recentres the mouth horizontally.
* **Chained trust-span repair** (:class:`RefinedMouthTracker`): frames
  where the sandwich agrees with the tracked trajectory are trusted;
  untrusted spans are re-tracked frame to frame from the nearest trusted
  frame, the template re-cut every step.
* **Per-frame articulation** (:func:`lip_opening`): the thickness of the
  dark inter-lip band moves the inner-mouth landmarks frame by frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from avsl_tpu_torch.data.lip_roi import canonical_mean_face
from avsl_tpu_torch.data.landmarks import (
    AnchorTrackDetector,
    EnergyBoxDetector,
    LandmarkDetector,
    MotionEnergyDetector,
    PrecomputedLandmarks,
)

# Canonical-face geometry constants (see lip_roi.canonical_mean_face):
# jaw-ellipse width at mouth height and full face width, in 300-space.
CANON_FACE_WIDTH_AT_MOUTH = 120.0


def _gaussian_blur(frame: np.ndarray, k: int) -> np.ndarray:
    import cv2

    return cv2.GaussianBlur(frame.astype(np.float32), (k, k), 0)


@dataclass
class RefinerConfig:
    """Thresholds are scale-relative where meaningful; absolute ones are
    in raw pixels and chosen loose enough to survive 2x resolution
    changes (AMI closeups are 288x352)."""

    # sandwich scan
    sandwich_halfwidth_frac: float = 0.12  # x-averaging half window / face width
    sandwich_offset_frac: float = 0.20  # philtrum/chin probe offset / face width
    min_darkness: float = 1.0  # local-max prominence floor (gray levels)
    conf_offset: float = 5.0  # min confidence to vote the global y offset
    conf_snap: float = 6.0  # min confidence for a per-frame snap
    conf_trust: float = 8.0  # min confidence to mark a frame trusted
    snap_gate_frac: float = 0.08  # per-frame snap gate / face width
    # skin scale
    skin_tol: float = 36.0  # |pixel - ref| skin classification (gray levels)
    width_smooth: int = 12  # temporal median half-window for face widths
    # chained repair
    chain_template_frac: float = 0.33
    chain_search: int = 12
    chain_min_corr: float = 0.2
    # x recalibration
    x_span: int = 10
    x_blend: float = 0.7
    # final smoothing windows (frames)
    smooth_x: int = 5
    smooth_y: int = 7
    # articulation
    articulate: bool = True
    opening_gain_max: float = 2.5  # max inner-gap multiplier vs canonical


def skin_reference(
    blurred: Sequence[np.ndarray], centers: np.ndarray, w_guess: float = 60.0
) -> float:
    """Clip-median skin gray level, sampled at certain-skin offsets
    (above the upper lip and on both upper cheeks) along the trajectory."""
    h, w = blurred[0].shape
    vals: List[float] = []
    offs = [(0, -0.22), (-0.15, -0.35), (0.15, -0.35), (0, -0.38),
            (-0.1, -0.2), (0.1, -0.2)]
    for t in range(len(blurred)):
        cx, cy = centers[t]
        for dx, dy in offs:
            x = int(cx + dx * w_guess)
            y = int(cy + dy * w_guess)
            if 2 <= x < w - 2 and 2 <= y < h - 2:
                vals.append(float(np.median(blurred[t][y - 2:y + 3, x - 2:x + 3])))
    return float(np.median(vals)) if vals else 128.0


def _gap_run_end(skin: np.ndarray, start: int, max_gap: int) -> int:
    """Vectorized twin of the outward gap-tolerant run walker: from
    ``start``, walking right, the position of the last skin pixel seen
    before ``max_gap`` consecutive non-skin pixels (``start`` itself if
    none). Mirror the array for the leftward run."""
    w = len(skin)
    idx = np.arange(start, w)
    # virtual skin at start-1 so a leading non-skin pixel at `start`
    # already counts gap 1, exactly like the walker's counter
    last_skin = np.maximum.accumulate(np.where(skin[start:], idx, start - 1))
    gap = idx - last_skin
    broke = gap > max_gap
    if broke.any():
        return max(int(last_skin[int(np.argmax(broke))]), start)
    return max(int(last_skin[-1]), start)


def face_width_at(
    frame: np.ndarray, cx: float, cy: float, ref: float,
    w_guess: float = 60.0, tol: float = 30.0,
) -> Optional[float]:
    """Median gap-tolerant skin-run width over the cheek band (rows from
    mouth level up to ~0.4 face widths above). Gap tolerance absorbs the
    mic boom and lip crossing the run."""
    h, w = frame.shape
    cx_i = int(cx)
    if not (0 <= cx_i < w):
        return None
    widths: List[int] = []
    max_gap = max(4, int(0.12 * w_guess))
    for frac in np.linspace(-0.40, 0.05, 12):
        y = int(cy + frac * w_guess)
        if y < 0 or y >= h:
            continue
        skin = np.abs(frame[y] - ref) < tol
        right = _gap_run_end(skin, cx_i, max_gap)
        left = (w - 1) - _gap_run_end(skin[::-1], (w - 1) - cx_i, max_gap)
        widths.append(right - left + 1)
    return float(np.median(widths)) if widths else None


def sandwich_y_candidates(
    frame: np.ndarray, cx: float, cy: float, face_w: float,
    band_frac: float = 0.5, cfg: RefinerConfig = RefinerConfig(),
) -> List[Tuple[int, float]]:
    """Lip-line y candidates near (cx, cy), scored by the sandwich test.

    Candidates are local maxima of darkness (x-averaged over a narrow
    window) relative to an 11-row moving baseline; the score is the
    *smaller* of the brightness margins at +-sandwich_offset_frac*face_w
    — both philtrum above and chin below must be brighter than the line.
    Returns up to 4 candidates sorted by score (desc)."""
    h, w = frame.shape
    xs0 = int(max(0, cx - cfg.sandwich_halfwidth_frac * face_w))
    xs1 = int(min(w, cx + cfg.sandwich_halfwidth_frac * face_w + 1))
    if xs1 - xs0 < 2:
        return []
    prof = frame[:, xs0:xs1].mean(axis=1)
    base = np.convolve(prof, np.ones(11) / 11, mode="same")
    d = base - prof
    y_lo = int(max(6, cy - band_frac * face_w))
    y_hi = int(min(h - 6, cy + band_frac * face_w))
    if y_hi - y_lo < 3:
        return []
    off = max(3, int(cfg.sandwich_offset_frac * face_w))
    # vectorized local-max detection + sandwich probes over the band
    ys = np.arange(y_lo + 1, y_hi - 1)
    peak = (d[ys] >= d[ys - 1]) & (d[ys] >= d[ys + 1]) & (d[ys] > cfg.min_darkness)
    ys = ys[peak]
    if ys.size == 0:
        return []
    c = np.concatenate([[0.0], np.cumsum(prof, dtype=np.float64)])
    # the philtrum (up) probe must reject rows whose probe window falls
    # off the frame top, exactly like the chin probe rejects off-bottom —
    # otherwise a clamped 0..2-row window near a bright frame top can
    # outscore the real lip line
    up_in_range = ys - off >= 0
    up_lo = np.maximum(0, ys - off)
    up_hi = np.maximum(1, ys - off + 3)
    up = np.where(
        up_in_range, (c[up_hi] - c[up_lo]) / np.maximum(up_hi - up_lo, 1), 0.0
    )
    in_range = ys + off < h
    dn_hi = np.minimum(ys + off + 1, h)
    dn_lo = np.maximum(np.minimum(ys + off - 2, dn_hi - 1), 0)
    dn = np.where(
        in_range, (c[dn_hi] - c[dn_lo]) / np.maximum(dn_hi - dn_lo, 1), 0.0
    )
    scores = np.minimum(up, dn) - prof[ys]
    order = np.argsort(-scores, kind="stable")[:4]
    return [(int(ys[k]), float(scores[k])) for k in order]


def sandwich_best_x(
    frame: np.ndarray, cx: float, cy: float, face_w: float,
    span: int = 10, cfg: RefinerConfig = RefinerConfig(),
) -> Tuple[Optional[int], float]:
    """x in [cx-span, cx+span] maximizing the sandwich response at the
    (already-refined) lip-line y. The response peaks when the averaging
    window is centered on the mouth: the philtrum directly above the lip
    center is the brightest above-context, and off-mouth columns dilute
    the dark line.

    Vectorized over the whole x-scan (one cumsum per row band instead of
    2*span+1 slice-means — this is the host preprocessing hot spot)."""
    h, w = frame.shape
    off = max(3, int(cfg.sandwich_offset_frac * face_w))
    y = int(cy)
    if y - off < 0 or y + off >= h:
        return None, -1e9
    half = cfg.sandwich_halfwidth_frac * face_w
    rows_up = frame[max(0, y - off):max(1, y - off + 3)].mean(axis=0)
    rows_dn = frame[y + off - 2:y + off + 1].mean(axis=0)
    row_y = frame[y].astype(np.float64)

    xs = np.arange(int(cx) - span, int(cx) + span + 1)
    x0s = np.clip((xs - half).astype(int), 0, w)
    x1s = np.clip((xs + half + 1).astype(int), 0, w)
    widths = x1s - x0s
    valid = widths >= 2

    def windowed(v: np.ndarray) -> np.ndarray:
        c = np.concatenate([[0.0], np.cumsum(v, dtype=np.float64)])
        return (c[x1s] - c[x0s]) / np.maximum(widths, 1)

    s = np.minimum(windowed(rows_up), windowed(rows_dn)) - windowed(row_y)
    s = np.where(valid, s, -1e9)
    k = int(np.argmax(s))
    if s[k] <= -1e9:
        return None, -1e9
    return int(xs[k]), float(s[k])


def lip_opening(
    frame: np.ndarray, cx: float, cy: float, face_w: float,
    cfg: RefinerConfig = RefinerConfig(),
) -> Tuple[float, float]:
    """Vertical thickness of the dark inter-lip band at (cx, cy).

    Returns (thickness_px, confidence). Thickness counts contiguous rows
    around the lip line whose darkness exceeds half the line's darkness —
    a closed mouth gives the line width (~2-3 px at AMI scale), an open
    mouth the dark mouth-interior extent."""
    h, w = frame.shape
    xs0 = int(max(0, cx - cfg.sandwich_halfwidth_frac * face_w))
    xs1 = int(min(w, cx + cfg.sandwich_halfwidth_frac * face_w + 1))
    if xs1 - xs0 < 2:
        return 0.0, 0.0
    prof = frame[:, xs0:xs1].mean(axis=1)
    y = int(np.clip(cy, 1, h - 2))
    # re-peak locally (the smoothed trajectory may sit a row off the line)
    lo = max(1, y - 3)
    y = lo + int(np.argmin(prof[lo:y + 4]))
    # skin level from the philtrum/chin probes (a moving-average baseline
    # saturates when the mouth is open and the dark band is thick)
    off = max(3, int(cfg.sandwich_offset_frac * face_w))
    if y - off < 0 or y + off >= h:
        return 0.0, 0.0
    up = prof[max(0, y - off):max(1, y - off + 3)].mean()
    dn = prof[y + off - 2:y + off + 1].mean()
    depth = min(up, dn) - prof[y]
    if depth <= cfg.min_darkness:
        return 0.0, 0.0
    level = prof[y] + 0.5 * depth
    top = y
    while top > max(0, y - off + 1) and prof[top - 1] < level:
        top -= 1
    bot = y
    while bot < min(h - 1, y + off - 1) and prof[bot + 1] < level:
        bot += 1
    return float(bot - top + 1), float(depth)


class RefinedMouthTracker(LandmarkDetector):
    """Production landmark detector: tracked + image-measured geometry.

    Pipeline per clip (all host-side; the downstream warp and crop run on
    a device, kernels/warp.py):

    1. coarse anchor: base detector box + articulation-map centroid near
       its mouth estimate (jaw/chin motion makes the centroid y-biased —
       only used to seed tracking),
    2. fixed-template bidirectional NCC track (AnchorTrackDetector),
    3. absolute scale from cheek-band skin runs (clip-median skin ref),
    4. lip-line y: sandwich candidates -> clip-median offset correction
       -> gated per-frame snap; frames that agree are *trusted*,
    5. untrusted spans re-tracked frame-to-frame from the nearest
       trusted frame (template re-grabbed every step),
    6. per-frame x recalibration by the sandwich response scanned over x,
    7. temporal smoothing (x window 5, y window 7 — the reference smooths
       landmarks over 12 frames downstream as well),
    8. canonical 68-point layout at the measured scale anchored at the
       refined center, inner-mouth points articulated by the measured
       lip opening.

    Falls back to the plain anchored-track layout when the sandwich scan
    never reaches confidence (no visible lip contrast)."""

    @staticmethod
    def photometric_normalize(frames: np.ndarray) -> np.ndarray:
        """Per-clip 2-98 percentile contrast stretch, for DETECTION only
        (geometry out; the warp samples the original frames). Lifts
        under-exposed / gamma-crushed footage back into the intensity
        range the absolute-threshold stages (skin runs, lip-line
        darkness) were calibrated for — measured on the golden clip:
        gamma-1.6 footage 0.49 -> 0.85 NCC, 50-level under-exposure
        0.40 -> 0.57 (tests/test_landmark_heldout.py)."""
        lo, hi = np.percentile(frames, [2.0, 98.0])
        return np.clip(
            (frames.astype(np.float32) - lo) * (255.0 / max(hi - lo, 1.0)),
            0, 255,
        ).astype(np.uint8)

    @staticmethod
    def _needs_norm(frames: np.ndarray) -> bool:
        """Auto trigger: the clip is dark-shifted (median < 90) yet spans
        a real dynamic range (p98-p2 > 120), so the stretch recovers the
        calibrated intensity band without inventing contrast. Clips with
        an inherently narrow range (synthetic fixtures, IR) are left
        alone — absolute-threshold calibration there is ambiguous either
        way and stretching them measurably hurts scale estimation."""
        med = float(np.median(frames))
        if med >= 90.0:
            return False
        lo, hi = np.percentile(frames, [2.0, 98.0])
        return (hi - lo) > 120.0

    def __init__(self, base: Optional[LandmarkDetector] = None,
                 config: Optional[RefinerConfig] = None,
                 template: int = 40, search: int = 24,
                 layout: Optional[np.ndarray] = None,
                 photometric: str = "auto"):
        # the base detector only seeds the ANCHOR (one mid-clip frame);
        # every_n=4 skips 3/4 of its per-frame work with no effect on the
        # anchor choice beyond +-2 frames
        self.base = base or EnergyBoxDetector(every_n=4)
        self.cfg = config or RefinerConfig()
        self.template = template
        self.search = search
        # 68-point layout the emitted landmarks are an affine image of;
        # MUST match the warp's mean face (lip_roi.layout_face_width for
        # why). None = the parametric canonical face.
        self.layout = None if layout is None else np.asarray(layout)
        self.synthesizes_parametric_layout = layout is None
        if photometric not in ("auto", "on", "off"):
            raise ValueError(f"photometric must be auto/on/off, got "
                             f"{photometric!r}")
        self.photometric = photometric
        self._motion = MotionEnergyDetector()

    # -- stage 1+2: coarse anchor + NCC track ------------------------------
    def _coarse_track(self, frames: np.ndarray) -> Optional[np.ndarray]:
        t_total = len(frames)
        base_lms = self.base(frames)
        valid = [i for i, l in enumerate(base_lms) if l is not None]
        if not valid:
            return None
        anchor = min(valid, key=lambda i: abs(i - t_total // 2))
        mouth = base_lms[anchor][48:68].mean(axis=0)
        # articulation centroid near the base mouth estimate sharpens the
        # anchor x (the base box is center-prior driven and can be far off
        # horizontally); restricted to 45 px so collar/boom motion cannot
        # capture it
        lo = max(0, anchor - 14)
        chunk = frames[lo:min(lo + 28, t_total)]
        if len(chunk) >= 8:
            art = self._motion.articulation_map(chunk)
            h, w = art.shape
            yy, xx = np.mgrid[0:h, 0:w]
            near = ((xx - mouth[0]) ** 2 + (yy - mouth[1]) ** 2) < 45 ** 2
            a = np.where(near, art, 0)
            pos = a[a > 0]
            if pos.size:
                blob = a * (a >= np.percentile(pos, 85))
                tot = blob.sum()
                if tot > 0:
                    mouth = np.array(
                        [(blob * xx).sum() / tot, (blob * yy).sum() / tot],
                        np.float32,
                    )
        return self._track_from(frames, anchor, np.asarray(mouth, np.float32))

    # -- stage 5: chained frame-to-frame repair ----------------------------
    def _chain(self, blurred, src_t: int, dst_range, cen: np.ndarray,
               face_w: float) -> None:
        import cv2

        cfg = self.cfg
        h, w = blurred[0].shape
        half = max(6, int(cfg.chain_template_frac * face_w))
        search = cfg.chain_search
        px, py = cen[src_t]
        prev = src_t
        for t in dst_range:
            tx = int(np.clip(px, half, w - half))
            ty = int(np.clip(py, half, h - half))
            tmpl = blurred[prev][ty - half:ty + half, tx - half:tx + half]
            x0 = int(np.clip(px - half - search, 0, w - 1))
            y0 = int(np.clip(py - half - search, 0, h - 1))
            x1 = int(np.clip(px + half + search, 1, w))
            y1 = int(np.clip(py + half + search, 1, h))
            win = blurred[t][y0:y1, x0:x1]
            if win.shape[0] > 2 * half and win.shape[1] > 2 * half:
                res = cv2.matchTemplate(win, tmpl, cv2.TM_CCOEFF_NORMED)
                _, mx, _, loc = cv2.minMaxLoc(res)
                if mx > cfg.chain_min_corr:
                    px = x0 + loc[0] + half
                    py = y0 + loc[1] + half
            cands = sandwich_y_candidates(
                blurred[t], px, py, face_w, band_frac=0.15, cfg=cfg
            )
            if cands and cands[0][1] > cfg.conf_offset and abs(cands[0][0] - py) <= 5:
                py = 0.5 * py + 0.5 * cands[0][0]
            cen[t] = (px, py)
            prev = t

    # -- bootstrap: (scale <-> lip-line y) fixed point ---------------------
    def _bootstrap(self, blur3, blur5, track):
        """Two passes of (skin-run scale at current centers -> sandwich
        y-snap at current scale), resolving their chicken-and-egg: the
        scale's cheek band is placed relative to the mouth center and the
        y-snap's band/probes are scale-relative. A coarse-anchor bias
        that poisons the first scale pass (degenerate widths measured
        with the band off the face) is corrected by the wide-band first
        y-snap, and the second pass then measures real widths.

        -> (centers [T,2], sm_w [T], y_conf [T], no_lip_contrast)."""
        cfg = self.cfg
        t_total = len(track)
        h, w = blur3[0].shape
        centers = track.copy()
        face_w = 60.0
        sm_w = np.full(t_total, face_w)
        y_conf = np.zeros(t_total)
        no_lip_contrast = False
        scale_ok = False
        for _pass in range(2):
            if not scale_ok:
                # (re)measure widths; once a pass yields healthy widths,
                # later passes keep them — re-measuring at the snapped
                # centers perturbs the per-frame scale the golden
                # comparison validated, while a degenerate first pass
                # (cheek band off the face) NEEDS the re-measure after
                # the y-snap recenters
                ref = skin_reference(blur5, centers, w_guess=face_w)
                widths = []
                for t in range(t_total):
                    w1 = face_width_at(
                        blur5[t], *centers[t], ref, face_w, cfg.skin_tol
                    )
                    w2 = face_width_at(
                        blur5[t], *centers[t], ref,
                        float(np.clip(w1 if w1 else face_w, 35, 110)),
                        cfg.skin_tol,
                    )
                    widths.append(w2 if w2 else np.nan)
                widths = np.asarray(widths, np.float64)
                # outlier rejection against the clip median: the face
                # scale varies slowly within a clip (dlib's similarity
                # fit moves ~±10%/s on the AMI golden pair) while
                # per-frame skin-run failures (band off the face during
                # fast motion) are sudden collapses to a few pixels
                med = np.nanmedian(widths)
                if np.isfinite(med) and med > 0:
                    ok = (widths > 0.7 * med) & (widths < 1.4 * med)
                    widths = np.where(ok, widths, np.nan)
                pass_sm = np.array([
                    np.nanmedian(
                        widths[max(0, t - cfg.width_smooth):
                               t + cfg.width_smooth + 1]
                    )
                    for t in range(t_total)
                ])
                pass_sm = np.where(np.isfinite(pass_sm), pass_sm, med)
                pass_face_w = float(np.nanmedian(pass_sm))
                # plausibility guard: a cheek band off the face measures
                # either a few pixels (background rejected as non-skin)
                # or the whole frame (centers below the face lock the
                # skin reference onto the background). Either way,
                # emitting it as scale would wreck the layout — keep the
                # default and let the y-snap recenter first.
                if (
                    np.isfinite(pass_face_w)
                    and 28.0 <= pass_face_w <= 0.8 * min(h, w)
                ):
                    sm_w = pass_sm
                    face_w = pass_face_w
                    scale_ok = True

            # lip-line y snap at the current scale. The first pass scans
            # a wide band (the coarse anchor can sit half a face-width
            # off on hard content — e.g. below the chin); once the global
            # offset has been applied, later passes narrow to the
            # validated band.
            band = 0.8 if _pass == 0 else 0.5
            cand_by_t = [
                sandwich_y_candidates(
                    blur3[t], centers[t, 0], centers[t, 1], face_w,
                    band_frac=band, cfg=cfg,
                )
                for t in range(t_total)
            ]
            offsets = [
                c[0][0] - centers[t, 1]
                for t, c in enumerate(cand_by_t)
                if c and c[0][1] > cfg.conf_offset
            ]
            if not offsets:
                no_lip_contrast = True
                break
            y_corr = centers[:, 1] + float(np.median(offsets))
            y_ref = y_corr.copy()
            y_conf = np.zeros(t_total)
            gate = max(4.0, cfg.snap_gate_frac * face_w)
            for t in range(t_total):
                for (cy, s) in cand_by_t[t]:
                    if s > cfg.conf_snap and abs(cy - y_corr[t]) <= gate:
                        y_ref[t] = 0.5 * y_corr[t] + 0.5 * cy
                        y_conf[t] = s
                        break
            centers = np.stack([centers[:, 0], y_ref], axis=1)
        return centers, sm_w, y_conf, no_lip_contrast

    def _global_anchor_scan(self, blur3, frame_idx: int,
                            face_w: float = 60.0):
        """Whole-frame sandwich scan: the strongest bright-dark-bright
        line candidate anywhere in the anchor frame. Used only when the
        local bootstrap finds (almost) no confident lip evidence — the
        coarse anchor was beyond every local stage's capture range."""
        cfg = self.cfg
        f = blur3[frame_idx]
        h, w = f.shape
        best = None
        for x in np.linspace(0.12 * w, 0.88 * w, 13):
            cands = sandwich_y_candidates(
                f, float(x), h / 2.0, face_w,
                band_frac=(h / 2.0 - 8) / face_w, cfg=cfg,
            )
            for (cy, s) in cands[:2]:
                if best is None or s > best[2]:
                    best = (float(x), float(cy), s)
        if best is None or best[2] <= cfg.conf_snap:
            return None
        # sharpen x at the found y
        bx, bs = sandwich_best_x(
            f, best[0], best[1], face_w, span=int(0.1 * w), cfg=cfg
        )
        return np.array(
            [bx if bx is not None else best[0], best[1]], np.float32
        )

    def _track_from(self, frames, anchor: int, pos: np.ndarray):
        canon = canonical_mean_face(300)
        seed = canon * 0.5 + (pos - (canon * 0.5)[48:68].mean(axis=0))
        per_frame: List[Optional[np.ndarray]] = [None] * len(frames)
        per_frame[anchor] = seed.astype(np.float32)
        tracker = AnchorTrackDetector(
            base=PrecomputedLandmarks(per_frame),
            template=self.template, search=self.search,
        )
        return np.array([l[48:68].mean(axis=0) for l in tracker(frames)])

    # -- full pipeline -----------------------------------------------------
    def refine(self, frames: np.ndarray):
        """-> (centers [T,2], widths [T], openings [T] | None) or None."""
        cfg = self.cfg
        t_total, h, w = frames.shape[:3]
        track = self._coarse_track(frames)
        if track is None:
            return None
        blur3 = [_gaussian_blur(f, 3) for f in frames]
        blur5 = [_gaussian_blur(f, 5) for f in frames]

        centers, sm_w, y_conf, no_lip = self._bootstrap(blur3, blur5, track)

        # global rescue: (almost) no frame produced a confident sandwich
        # hit — the coarse anchor sat beyond local capture (e.g. below
        # the chin). Re-anchor from a whole-frame scan and re-bootstrap;
        # keep whichever run has more confident frames.
        conf_frac = float((y_conf > cfg.conf_snap).mean())
        if conf_frac < 0.2:
            pos = self._global_anchor_scan(blur3, t_total // 2)
            if pos is not None:
                track2 = self._track_from(frames, t_total // 2, pos)
                c2, w2, conf2, nl2 = self._bootstrap(blur3, blur5, track2)
                if float((conf2 > cfg.conf_snap).mean()) > conf_frac:
                    track, centers, sm_w, y_conf, no_lip = (
                        track2, c2, w2, conf2, nl2
                    )

        if no_lip and np.allclose(centers, track):
            # no lip evidence anywhere: plain tracked layout
            return track, sm_w, None
        cen = centers
        conf = y_conf
        face_w = float(np.nanmedian(sm_w))

        # repair untrusted spans
        trusted = conf > cfg.conf_trust
        if trusted.any() and not trusted.all():
            t = 0
            while t < t_total:
                if not trusted[t]:
                    u0 = t
                    while t < t_total and not trusted[t]:
                        t += 1
                    u1 = t - 1
                    left = u0 - 1 if u0 > 0 else None
                    right = u1 + 1 if u1 < t_total - 1 else None
                    if left is not None and right is not None:
                        mid = (u0 + u1) // 2
                        self._chain(blur3, left, range(u0, mid + 1), cen, face_w)
                        self._chain(blur3, right, range(u1, mid, -1), cen, face_w)
                    elif left is not None:
                        self._chain(blur3, left, range(u0, u1 + 1), cen, face_w)
                    elif right is not None:
                        self._chain(blur3, right, range(u1, u0 - 1, -1), cen, face_w)
                else:
                    t += 1

        # x recalibration
        for t in range(t_total):
            bx, bs = sandwich_best_x(
                blur3[t], cen[t, 0], cen[t, 1], face_w, span=cfg.x_span, cfg=cfg
            )
            if bx is not None and bs > cfg.conf_snap:
                cen[t, 0] = (1 - cfg.x_blend) * cen[t, 0] + cfg.x_blend * bx

        # smoothing
        def smooth(v: np.ndarray, win: int) -> np.ndarray:
            win |= 1  # edge-pad + 'valid' preserves length for ODD wins only
            if t_total < win:
                return v
            half = win // 2
            return np.convolve(np.pad(v, half, mode="edge"),
                               np.ones(win) / win, mode="valid")

        cen[:, 0] = smooth(cen[:, 0], cfg.smooth_x)
        cen[:, 1] = smooth(cen[:, 1], cfg.smooth_y)

        openings = None
        if cfg.articulate:
            openings = np.zeros(t_total)
            for t in range(t_total):
                thick, oc = lip_opening(blur3[t], cen[t, 0], cen[t, 1], face_w, cfg)
                openings[t] = thick if oc > cfg.min_darkness else np.nan
        return cen, sm_w, openings

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        frames = np.asarray(frames)
        if self.photometric == "on" or (
            self.photometric == "auto" and self._needs_norm(frames)
        ):
            # detect on the contrast-stretched clip; emitted geometry
            # applies to the original frames unchanged
            frames = self.photometric_normalize(frames)
        out = self.refine(frames)
        if out is None:
            # no anchor/scale at all: defer to the plain anchored tracker —
            # in the SAME layout, so the downstream warp (whose mean face
            # must match self.layout) never sees mixed-layout landmarks
            return AnchorTrackDetector(
                base=self.base, template=self.template, search=self.search,
                layout=self.layout,
            )(frames)
        cen, sm_w, openings = out
        if self.layout is not None:
            from avsl_tpu_torch.data.lip_roi import layout_face_width_at_mouth

            canon = np.asarray(self.layout, np.float64)
            width_at_mouth = layout_face_width_at_mouth(canon)
        else:
            canon = canonical_mean_face(300).astype(np.float64)
            width_at_mouth = CANON_FACE_WIDTH_AT_MOUTH
        canon_mouth = canon[48:68].mean(axis=0)
        base_layout = canon - canon_mouth
        t_total = len(frames)

        gains = np.ones(t_total)
        if openings is not None and np.isfinite(openings).sum() >= 3:
            neutral = float(np.nanmedian(openings))
            if neutral > 0:
                g = openings / neutral
                g = np.where(np.isfinite(g), g, 1.0)
                gains = np.clip(g, 1.0 / self.cfg.opening_gain_max,
                                self.cfg.opening_gain_max)

        inner = np.arange(60, 68)
        result: List[Optional[np.ndarray]] = []
        for t in range(t_total):
            s = sm_w[t] / width_at_mouth
            if not np.isfinite(s) or s <= 0:
                s = float(np.nanmedian(sm_w)) / width_at_mouth
            lm = base_layout.copy()
            # articulate the inner-lip gap about the mouth center line
            lm[inner, 1] *= gains[t]
            result.append((s * lm + cen[t]).astype(np.float32))
        return result
