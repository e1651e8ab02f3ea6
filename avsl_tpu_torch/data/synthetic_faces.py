"""Procedural synthetic-face generator for landmark-detector training.

Port of ``avsl_tpu/data/synthetic_faces.py``, numpy on the host and bit
for bit the JAX package's for the same seed; it reads the port's own
``data/lip_roi.canonical_mean_face``, ``data/lip_refine.RefinedMouthTracker``
and ``data/video_io.read_video_frames``.

There are no face datasets and no pretrained detectors of any kind
offline, so the trainable CNN landmark detector (data/landmarks.py) is
bootstrapped on procedurally rendered faces: the canonical 68-point layout
under a random similarity transform, rendered as smooth intensity blobs
(skin ellipse, darker eyes/brows/nostrils, mouth with random openness)
over structured backgrounds (noise, curtain-like stripes, gradients), with
random polarity, contrast, occluding strokes (microphone booms) and sensor
noise. Labels are exact by construction.

Not photoreal — the goal is a detector that localizes face-like intensity
structure under the transforms the lip pipeline cares about, trained
entirely offline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from avsl_tpu_torch.data.lip_roi import canonical_mean_face


def _blob(xx, yy, cx, cy, rx, ry, amp):
    return amp * np.exp(-(((xx - cx) / max(rx, 1e-3)) ** 2 + ((yy - cy) / max(ry, 1e-3)) ** 2))


def render_face(
    rng: np.random.Generator, size: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image [size,size] float32 in [0,255], landmarks [68,2]) sample."""
    canon = canonical_mean_face(300).astype(np.float64)  # x in [72,228], y in [100,270]

    # similarity transform: scale so face width spans 30-85% of the frame
    face_span = 156.0
    scale = rng.uniform(0.30, 0.85) * size / face_span
    theta = rng.normal(0.0, 0.12)  # ~±20° tail
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    center = canon.mean(axis=0)
    pts = (canon - center) @ rot.T * scale
    # keep the face roughly inside the frame
    margin = 0.18 * size
    tx = rng.uniform(margin, size - margin)
    ty = rng.uniform(margin, size - margin)
    lms = pts + np.array([tx, ty])

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)

    # --- background ---
    img = rng.uniform(40, 160) * np.ones((size, size))
    img += rng.normal(0, rng.uniform(2, 15), (size, size))
    if rng.random() < 0.6:  # curtain-like vertical stripes
        freq = rng.uniform(0.05, 0.3)
        img += rng.uniform(5, 40) * np.sin(xx * freq + rng.uniform(0, 6))
    if rng.random() < 0.5:  # broad gradient
        gx, gy = rng.normal(0, 0.3, 2)
        img += gx * (xx - size / 2) + gy * (yy - size / 2)

    # --- face ---
    polarity = 1.0 if rng.random() < 0.5 else -1.0  # lighter or darker than bg
    skin_amp = polarity * rng.uniform(30, 80)
    jaw = lms[0:17]
    fc = lms.mean(axis=0)
    rx = (jaw[:, 0].max() - jaw[:, 0].min()) / 1.8
    ry = (jaw[:, 1].max() - lms[17:27, 1].min()) / 1.6
    img += _blob(xx, yy, fc[0], fc[1], rx, ry, skin_amp)

    feat_amp = -polarity * rng.uniform(25, 60)  # features contrast the skin
    for eye in (lms[36:42], lms[42:48]):
        ec = eye.mean(axis=0)
        er = max((eye[:, 0].max() - eye[:, 0].min()) / 1.5, 1.0)
        img += _blob(xx, yy, ec[0], ec[1], er, er * 0.55, feat_amp)
    for brow in (lms[17:22], lms[22:27]):
        bc = brow.mean(axis=0)
        br = max((brow[:, 0].max() - brow[:, 0].min()) / 1.6, 1.0)
        img += _blob(xx, yy, bc[0], bc[1], br, br * 0.3, feat_amp * 0.7)
    nose = lms[31:36].mean(axis=0)
    img += _blob(xx, yy, nose[0], nose[1], 2.5 * scale * 3, 1.5 * scale * 3, feat_amp * 0.5)

    mouth = lms[48:68]
    mc = mouth.mean(axis=0)
    mw = max((mouth[:, 0].max() - mouth[:, 0].min()) / 1.7, 1.0)
    mh = max((mouth[:, 1].max() - mouth[:, 1].min()) / 1.2, 0.8)
    openness = rng.uniform(0.6, 2.2)  # articulating mouth
    img += _blob(xx, yy, mc[0], mc[1], mw, mh * openness, feat_amp * rng.uniform(0.8, 1.3))

    # --- occluders: mic boom style strokes ---
    if rng.random() < 0.5:
        x0, y0 = rng.uniform(0, size, 2)
        ang = rng.uniform(0, np.pi)
        d = np.abs((xx - x0) * np.sin(ang) - (yy - y0) * np.cos(ang))
        img += np.where(d < rng.uniform(1, 3), rng.uniform(-80, 80), 0.0)

    img += rng.normal(0, rng.uniform(1, 8), (size, size))  # sensor noise
    img = np.clip(img, 0, 255)
    return img.astype(np.float32), lms.astype(np.float32)


def generate_dataset(
    n: int, size: int = 128, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(images [N,size,size], landmarks [N,68,2] normalized to [0,1])."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, size, size), np.float32)
    lms = np.empty((n, 68, 2), np.float32)
    for i in range(n):
        img, l = render_face(rng, size)
        imgs[i] = img
        lms[i] = l / size
    return imgs, lms


def pseudo_label_dataset(
    video_paths, per_frame: int = 8, size: int = 128, seed: int = 0,
    max_frames: int = 300,
):
    """Real-footage training pairs pseudo-labeled by the refined tracker.

    Each clip is labeled once with data.lip_refine.RefinedMouthTracker
    (the preprocessing-default detector, golden-validated against the
    reference's dlib crops), then every frame yields ``per_frame``
    augmented crops: a random window containing the face at a random
    scale (so the CNN sees the face at many apparent sizes), resized to
    ``size`` with brightness/contrast/noise jitter. Landmarks map through
    the same window -> normalized [0,1] coords.

    Returns (images [N,size,size] float32, landmarks [N,68,2] in [0,1]).
    """
    import cv2

    from avsl_tpu_torch.data.lip_refine import RefinedMouthTracker
    from avsl_tpu_torch.data.video_io import read_video_frames

    rng = np.random.default_rng(seed)
    det = RefinedMouthTracker()
    imgs, lms_out = [], []
    for path in video_paths:
        frames = read_video_frames(path, grayscale=True, max_frames=max_frames)
        lms = det(frames)
        h, w = frames.shape[1:3]
        for t in range(len(frames)):
            lm = lms[t]
            if lm is None:
                continue
            face_w = float(lm[:, 0].max() - lm[:, 0].min())
            cx, cy = lm[48:68].mean(axis=0)
            for _ in range(per_frame):
                # window side: face occupies 25-90% of the crop
                side = face_w / rng.uniform(0.25, 0.90)
                side = float(np.clip(side, 32, 2 * max(h, w)))
                # face center lands anywhere in the middle half of the crop
                jx = rng.uniform(-0.22, 0.22) * side
                jy = rng.uniform(-0.22, 0.22) * side
                x0 = cx + jx - side / 2
                y0 = cy + jy - side / 2
                # integer window clipped to the frame (pad if short)
                xi, yi = int(round(x0)), int(round(y0))
                win = np.zeros((int(side), int(side)), np.float32)
                sx0, sy0 = max(0, xi), max(0, yi)
                sx1 = min(w, xi + int(side))
                sy1 = min(h, yi + int(side))
                if sx1 <= sx0 or sy1 <= sy0:
                    continue
                win[sy0 - yi: sy1 - yi, sx0 - xi: sx1 - xi] = frames[
                    t, sy0:sy1, sx0:sx1
                ]
                img = cv2.resize(win, (size, size))
                # photometric jitter
                gain = rng.uniform(0.7, 1.3)
                bias = rng.uniform(-20, 20)
                img = np.clip(img * gain + bias, 0, 255)
                img = img + rng.normal(0, rng.uniform(0, 4), img.shape)
                norm = (lm - np.array([xi, yi], np.float32)) / float(int(side))
                imgs.append(np.clip(img, 0, 255).astype(np.float32))
                lms_out.append(norm.astype(np.float32))
    if not imgs:
        return (np.zeros((0, size, size), np.float32),
                np.zeros((0, 68, 2), np.float32))
    return np.stack(imgs), np.stack(lms_out)
