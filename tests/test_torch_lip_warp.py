"""Port of kernels/warp.py against the JAX functions (CPU, float32).

The same seeded landmarks and frames go through ``avsl_tpu.kernels.warp``
(jitted on the CPU) and ``avsl_tpu_torch.kernels.warp``. Tolerances: the
transform coefficients and coordinates within 1e-4 relative (fp32 sums in
another order); the crops within 1e-2 grey levels (the same taps at
coordinates that differ by float rounding), the separable sampler within
2e-3 (fp32 products of exact bilinear weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsl_tpu.data.lip_roi import canonical_mean_face
from avsl_tpu.kernels import warp as jw
from avsl_tpu_torch.kernels import warp as tw
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_lip_fixtures import blob_clips, landmarks_for

COEF_TOL = dict(rtol=1e-4, atol=1e-4)
CROP_TOL = dict(rtol=0.0, atol=1e-2)
SAMPLE_TOL = dict(rtol=0.0, atol=2e-3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def case():
    clips = blob_clips(b=2, t=6)
    lms = landmarks_for(clips.shape, seed=1)
    lms_rot = landmarks_for(clips.shape, seed=2, rotate=0.15)
    return clips, lms, lms_rot, canonical_mean_face(300)


def test_torch_similarity_coeffs_match_jax(case):
    _, lms, lms_rot, mf = case
    for src in (lms, lms_rot):
        want = jw.similarity_coeffs(jnp.asarray(src), jnp.asarray(mf))
        got = tw.similarity_coeffs(_t(src), _t(mf))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **COEF_TOL)
        inv_w = jw.inverse_coeffs(want)
        inv_g = tw.inverse_coeffs(got)
        for g, w in zip(inv_g, inv_w):
            np.testing.assert_allclose(_np(g), np.asarray(w), **COEF_TOL)
        np.testing.assert_allclose(_np(tw.apply_coeffs(_t(src), got)),
                                   np.asarray(jw.apply_coeffs(jnp.asarray(src), want)), rtol=1e-4,
                                   atol=1e-3)
    m_w = jw.umeyama(jnp.asarray(lms_rot[0, 0]), jnp.asarray(mf))
    m_g = tw.umeyama(_t(lms_rot[0, 0]), _t(mf))
    np.testing.assert_allclose(_np(m_g), np.asarray(m_w), **COEF_TOL)
    np.testing.assert_allclose(_np(tw.invert_similarity(m_g)),
                               np.asarray(jw.invert_similarity(m_w)), **COEF_TOL)
    pts = lms_rot[1, 2]
    np.testing.assert_allclose(_np(tw.transform_points(_t(pts), m_g)),
                               np.asarray(jw.transform_points(jnp.asarray(pts), m_w)), rtol=1e-4,
                               atol=1e-3)


def test_torch_warp_frame_matches_jax(case):
    clips, _, lms_rot, mf = case
    m = jw.umeyama(jnp.asarray(lms_rot[0, 0]), jnp.asarray(mf))
    want = jax.jit(jw.warp_frame, static_argnums=(2, 3))(jnp.asarray(clips[0, 0]), m, 120, 100)
    got = tw.warp_frame(_t(clips[0, 0]), _t(np.asarray(m)), 120, 100)
    assert got.shape == (120, 100) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **CROP_TOL)


@pytest.mark.parametrize("rotated", [False, True])
def test_torch_warp_and_crop_clip_matches_jax(case, rotated):
    """The gather warp on a batch of clips [2, 6, H, W], rotation-free
    and rotated landmarks, some taps outside the frame."""
    clips, lms, lms_rot, mf = case
    src = lms_rot if rotated else lms
    want = jw.warp_and_crop_clip(jnp.asarray(clips), jnp.asarray(src), jnp.asarray(mf))
    got = tw.warp_and_crop_clip(_t(clips), _t(src), _t(mf))
    assert got.shape == (2, 6, 96, 96)
    np.testing.assert_allclose(_np(got), np.asarray(want), **CROP_TOL)


def test_torch_separable_coords_match_jax(case):
    _, lms, _, mf = case
    ys_w, xs_w = jw.separable_crop_coords(jnp.asarray(lms), jnp.asarray(mf))
    ys_g, xs_g = tw.separable_crop_coords(_t(lms), _t(mf))
    np.testing.assert_allclose(_np(ys_g), np.asarray(ys_w), **COEF_TOL)
    np.testing.assert_allclose(_np(xs_g), np.asarray(xs_w), **COEF_TOL)
    ys_n, xs_n = tw.separable_crop_coords_np(lms, mf, crop_size=88)
    ys_jn, xs_jn = jw.separable_crop_coords_np(lms, mf, crop_size=88)
    np.testing.assert_array_equal(ys_n, ys_jn)  # the same numpy code
    np.testing.assert_array_equal(xs_n, xs_jn)
    np.testing.assert_allclose(ys_n, np.asarray(jw.separable_crop_coords(
        jnp.asarray(lms), jnp.asarray(mf), crop_size=88)[0]), **COEF_TOL)


@pytest.mark.parametrize("n_frames,chunk", [(12, 32), (70, 32), (64, 16)])
def test_torch_sample_separable_matches_jax(n_frames, chunk):
    """Unchunked (n <= chunk), chunked with a padded last group, and
    chunked exactly; the coordinates reach 2 px past every frame edge, so
    the per-tap masking at (-1, 0) and (n-1, n) and the zero beyond are
    held too."""
    rng = np.random.default_rng(n_frames)
    frames = rng.integers(0, 256, (n_frames, 61, 77), np.uint8)
    ys = rng.uniform(-2.0, 63.0, (n_frames, 24)).astype(np.float32)
    xs = rng.uniform(-2.0, 79.0, (n_frames, 24)).astype(np.float32)
    ys[:, 0], xs[:, 0] = -0.5, 76.5  # single in-frame taps
    ys[:, 1], xs[:, 1] = -1.5, 78.0  # no in-frame tap
    want = np.asarray(jw.sample_separable(jnp.asarray(frames), jnp.asarray(ys), jnp.asarray(xs),
                                          chunk=chunk))
    got = _np(tw.sample_separable(_t(frames), _t(ys), _t(xs), chunk=chunk))
    assert got.shape == (n_frames, 24, 24)
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    assert np.all(got[:, 1, :] == 0) and np.all(got[:, :, 1] == 0)
    # batched leading dims give the same crops
    got_b = tw.sample_separable(_t(frames).reshape(2, -1, 61, 77), _t(ys).reshape(2, -1, 24),
                                _t(xs).reshape(2, -1, 24), chunk=chunk)
    np.testing.assert_allclose(_np(got_b).reshape(got.shape), got, **SAMPLE_TOL)


def test_torch_separable_warp_matches_jax_and_gather_warp(case):
    clips, lms, _, mf = case
    want = jw.warp_and_crop_clip_separable(jnp.asarray(clips), jnp.asarray(lms), jnp.asarray(mf))
    got = tw.warp_and_crop_clip_separable(_t(clips), _t(lms), _t(mf))
    np.testing.assert_allclose(_np(got), np.asarray(want), **CROP_TOL)
    # landmarks without rotation: the separable and gather warps agree
    shift = np.random.default_rng(4).uniform(-20, 20, clips.shape[:2] + (1, 2))
    flat = (0.5 * mf + shift + np.array([15.0, 0.0])).astype(np.float32)
    sep = _np(tw.warp_and_crop_clip_separable(_t(clips), _t(flat), _t(mf)))
    gather = _np(tw.warp_and_crop_clip(_t(clips), _t(flat), _t(mf)))
    np.testing.assert_allclose(sep, gather, **CROP_TOL)


def test_torch_frame_helpers_match_jax():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (3, 20, 30, 3), np.uint8)
    np.testing.assert_allclose(_np(tw.rgb_to_grayscale(_t(rgb))),
                               np.asarray(jw.rgb_to_grayscale(jnp.asarray(rgb))), rtol=0, atol=1e-4)
    gray = rng.integers(0, 256, (3, 20, 30), np.uint8)
    np.testing.assert_array_equal(_np(tw.center_crop(_t(gray), 12)),
                                  np.asarray(jw.center_crop(jnp.asarray(gray), 12)))
    for x in (gray, gray.astype(np.float32) / 255.0):
        np.testing.assert_allclose(_np(tw.normalize_frames(_t(x))),
                                   np.asarray(jw.normalize_frames(jnp.asarray(x))), rtol=1e-6,
                                   atol=1e-5)
