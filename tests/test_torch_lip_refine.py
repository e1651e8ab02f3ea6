"""Port of data/lip_refine.py and data/lip_roi.py against the JAX package.

``RefinedMouthTracker`` (the ``host_refined`` serving mode's detector) and
its measurements are numpy and OpenCV on both sides: equal exactly, on a
rendered talking face whose mouth sweeps sideways, on a dark clip (the
photometric stretch) and on a static clip (the anchored-track fallback).
The lip_roi bookkeeping is numpy too: equal exactly. ``extract_lip_clip``
warps on the port's device: its uint8 crops within 1 grey level of the
JAX ones (float32 taps at coordinates that differ by rounding, then
truncated), a frame a pixel over only where the reference's crop-window
centre is on its knife edge (``torch_lip_fixtures.assert_crops_match``).
"""

import numpy as np
import pytest

from avsl_tpu.data import lip_refine as jr
from avsl_tpu.data import lip_roi as jroi
from avsl_tpu_torch.data import lip_refine as tr
from avsl_tpu_torch.data import lip_roi as troi
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_lip_fixtures import assert_crops_match, face_clip

CROP_ATOL = 1.0


@pytest.fixture(scope="module")
def face():
    return face_clip(t=30)


def _lists_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)


def test_torch_refiner_measurements_match_jax(face):
    frames, truth = face
    f = jr._gaussian_blur(frames[5], 5)
    cx, cy = truth[5]
    ref = jr.skin_reference([f], truth[5:6], 60.0)
    assert tr.skin_reference([f], truth[5:6], 60.0) == ref
    assert tr.face_width_at(f, cx, cy, ref, 60.0) == jr.face_width_at(f, cx, cy, ref, 60.0)
    for band in (0.5, 0.8):
        assert tr.sandwich_y_candidates(f, cx, cy + 3, 60.0, band_frac=band) == \
            jr.sandwich_y_candidates(f, cx, cy + 3, 60.0, band_frac=band)
    assert tr.sandwich_best_x(f, cx + 4, cy, 60.0) == jr.sandwich_best_x(f, cx + 4, cy, 60.0)
    assert tr.lip_opening(f, cx, cy, 60.0) == jr.lip_opening(f, cx, cy, 60.0)
    assert tr.RefinerConfig() == tr.RefinerConfig(**vars(jr.RefinerConfig()))


@pytest.mark.parametrize("clip", ["face", "dark", "static"])
def test_torch_refined_tracker_matches_jax(face, clip):
    frames = face[0]
    if clip == "dark":  # median under 90 with a wide range: the stretch runs
        frames = (frames.astype(np.float32) * 0.5).astype(np.uint8)
        frames[:, :4, :4] = 250
    elif clip == "static":  # no motion, no lip contrast: the fallback layout
        frames = np.broadcast_to(np.full(frames.shape[1:], 90, np.uint8), frames.shape).copy()
    want = jr.RefinedMouthTracker()(frames)
    got = tr.RefinedMouthTracker()(frames)
    _lists_equal(got, want)
    assert jr.RefinedMouthTracker._needs_norm(frames) == tr.RefinedMouthTracker._needs_norm(frames)
    if clip == "face":
        assert all(w is not None for w in want)
        centre = np.array([w[48:68].mean(0) for w in want])
        assert np.abs(centre - face[1]).mean() < 6.0  # it finds the rendered mouth


def test_torch_lip_roi_bookkeeping_matches_jax(tmp_path):
    np.testing.assert_array_equal(troi.canonical_mean_face(300), jroi.canonical_mean_face(300))
    np.testing.assert_array_equal(troi.canonical_mean_face(150), jroi.canonical_mean_face(150))
    mf = jroi.canonical_mean_face(300)
    path = tmp_path / "mean_face.npy"
    np.save(path, mf * 1.01)
    np.testing.assert_array_equal(troi.load_mean_face(str(path)), jroi.load_mean_face(str(path)))
    np.testing.assert_array_equal(troi.resolve_mean_face(str(path)), jroi.resolve_mean_face(str(path)))
    np.testing.assert_array_equal(troi.resolve_mean_face(None), jroi.resolve_mean_face(None))
    np.save(path, np.zeros((5, 2)))
    with pytest.raises(ValueError):
        troi.load_mean_face(str(path))
    assert troi.layout_face_width(mf) == jroi.layout_face_width(mf)
    assert troi.layout_face_width_at_mouth(mf) == jroi.layout_face_width_at_mouth(mf)
    rng = np.random.default_rng(0)
    lms = (mf[None] * 0.4 + rng.normal(0, 2, (6, 68, 2))).astype(np.float32)
    np.testing.assert_array_equal(troi.relayout_landmarks(lms, mf * 1.1),
                                  jroi.relayout_landmarks(lms, mf * 1.1))
    sparse = [None, lms[1], None, None, lms[4], None]
    np.testing.assert_array_equal(troi.landmarks_interpolate(sparse),
                                  jroi.landmarks_interpolate(sparse))
    assert troi.landmarks_interpolate([None, None]) is None
    for window in (12, 3):
        np.testing.assert_array_equal(troi.smooth_landmarks(lms, window),
                                      jroi.smooth_landmarks(lms, window))


def test_torch_extract_lip_clip_matches_jax(face):
    """The refined tracker's landmarks and a motion detector's sparse
    window landmarks (interpolated), each warped by both packages."""
    frames = face[0]
    motion = jr.MotionEnergyDetector()(frames, window=10)
    for per_frame in (jr.RefinedMouthTracker()(frames), motion):
        want = jroi.extract_lip_clip(frames, per_frame)
        got = troi.extract_lip_clip(frames, per_frame, device="cpu")
        assert got.shape == want.shape == (len(frames), 96, 96) and got.dtype == np.uint8
        lms = jroi.smooth_landmarks(jroi.landmarks_interpolate(per_frame), 12)
        assert_crops_match(got.astype(np.float32), want.astype(np.float32), lms, CROP_ATOL)
    assert troi.extract_lip_clip(frames, [None] * len(frames), device="cpu") is None
