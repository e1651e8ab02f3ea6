"""Port of kernels/lip_pipeline.py against the JAX frontend (CPU, float32).

``masked_time_interp`` (duplicate centres included), ``smooth_time``,
``synthesize_traj`` and ``synthesize_landmarks`` (the canonical fallback
included) against the jitted JAX functions, batched against vmapped;
then every stage of ``make_staged_lip_frontend`` and the fused
``make_lip_frontend`` (with and without its mouth window) on closeups the
detector finds and one it does not. Decisions must be equal: ok flags and
the int32 window offsets; a warp's crops may sit a pixel off the JAX ones
only along an axis where the reference's int32 crop-window centre is on
its knife edge (``torch_lip_fixtures.assert_crops_match``). Trajectories
within 0.05 px (the detections' mouths agree within 1e-3 px at detection
scale; smoothing sums them in float32 prefix sums up to 1.6e4, where an ulp
is 1e-3), landmarks and sampling coordinates within 0.05 px, crops within
0.5 grey levels (the same bilinear taps at coordinates 0.05 px apart move a
pixel by at most 0.05 times the local gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsl_tpu.kernels import lip_pipeline as jp
from avsl_tpu_torch.kernels import lip_pipeline as tp
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_lip_fixtures import (
    DS,
    T,
    WINDOW,
    assert_crops_match,
    closeup_clips,
)

TRAJ_ATOL = 0.05
CROP_ATOL = 0.5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def clips():
    """Three 60-frame closeups: two moving heads and a static clip."""
    c = closeup_clips(b=3, t=60)
    c[2] = c[2, :1]
    return c


@pytest.fixture(scope="module")
def stages(clips):
    t = clips.shape[1]
    return jp.make_staged_lip_frontend(t, window=WINDOW, detect_ds=DS), \
        tp.make_staged_lip_frontend(t, window=WINDOW, detect_ds=DS)


def test_torch_masked_time_interp_matches_jax():
    """Valid patterns with gaps at either end and in the middle, and
    window centres that clamp to t - 1 and repeat."""
    rng = np.random.default_rng(2)
    nw, t = 5, 3 * WINDOW  # centres 12, 37, 62, 74, 74
    centers = np.minimum(np.arange(nw) * WINDOW + WINDOW // 2, t - 1)
    assert centers[-1] == centers[-2]
    values = (10 * rng.normal(size=(nw, 2))).astype(np.float32)
    fn = jax.jit(jp.masked_time_interp, static_argnums=3)
    patterns = ([1, 1, 1, 1, 1], [0, 1, 1, 0, 0], [1, 0, 0, 1, 0], [0, 0, 1, 0, 1], [0, 0, 0, 1, 1])
    for pattern in patterns:
        valid = np.asarray(pattern, bool)
        want = np.asarray(fn(jnp.asarray(values), jnp.asarray(valid), jnp.asarray(centers), t))
        got = _np(tp.masked_time_interp(_t(values), _t(valid), _t(centers), t))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # batched rows equal the rows one by one
    vb = np.stack([np.asarray(p, bool) for p in patterns])
    got_b = _np(tp.masked_time_interp(_t(np.broadcast_to(values, (5, nw, 2))), _t(vb), _t(centers), t))
    for i, p in enumerate(patterns):
        np.testing.assert_allclose(got_b[i], _np(tp.masked_time_interp(
            _t(values), _t(np.asarray(p, bool)), _t(centers), t)), rtol=0, atol=0)


@pytest.mark.parametrize("window", [12, 7, 100])
def test_torch_smooth_time_matches_jax(window):
    x = np.random.default_rng(window).normal(size=(T, 68, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jp.smooth_time, static_argnums=1)(jnp.asarray(x), window))
    np.testing.assert_allclose(_np(tp.smooth_time(_t(x), window)), want, rtol=0, atol=1e-5)
    got_d1 = _np(tp.smooth_time(_t(x).transpose(0, 1), window, dim=1).transpose(0, 1))
    np.testing.assert_allclose(got_d1, want, rtol=0, atol=1e-5)


def test_torch_synthesize_traj_matches_jax():
    """Four clips' detections: all windows valid (NW = 4, an even count for
    the window median), two valid, none valid (the clip estimate stands
    in), and a failed clip detection (the canonical layout)."""
    rng = np.random.default_rng(5)
    nw, t = 4, 110
    clip_det = np.array([[60, 70, 50, 1], [58, 66, 44, 1], [61, 69, 52, 1], [0, 0, 0, 0]],
                        np.float32)
    win_det = np.concatenate([clip_det[:, None, :2] + rng.normal(0, 6, (4, nw, 2)),
                              np.broadcast_to(clip_det[:, None, 2:3], (4, nw, 1)),
                              np.ones((4, nw, 1))], -1).astype(np.float32)
    win_det[1, [0, 2], 3] = 0.0
    win_det[2, :, 3] = 0.0
    fn = jax.jit(jax.vmap(lambda c, w: jp.synthesize_traj(c, w, t, window=WINDOW, detect_ds=DS)))
    want = [np.asarray(x) for x in fn(jnp.asarray(clip_det), jnp.asarray(win_det))]
    got = [_np(x) for x in tp.synthesize_traj(_t(clip_det), _t(win_det), t, window=WINDOW,
                                              detect_ds=DS)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TRAJ_ATOL)
    # the canonical fallback: the layout's mouth centre, face width 156
    np.testing.assert_allclose(got[0][3], np.broadcast_to(tp.canonical_mean_face(300)[48:68].mean(0),
                                                          (t, 2)), atol=1e-3)
    assert got[1][3] == 156.0 and not got[2][3]
    lw = np.asarray(jax.vmap(lambda c, w: jp.synthesize_landmarks(c, w, t, window=WINDOW,
                                                                  detect_ds=DS))(
        jnp.asarray(clip_det), jnp.asarray(win_det)))
    lg = _np(tp.synthesize_landmarks(_t(clip_det), _t(win_det), t, window=WINDOW, detect_ds=DS))
    np.testing.assert_allclose(lg, lw, rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(tp.synthesize_landmarks(_t(clip_det[3]), _t(win_det[3]), t))[0],
                               tp.canonical_mean_face(300), atol=1e-2)


def test_torch_staged_detection_stages_match_jax(clips, stages):
    """subsample, landmarks, traj (ok flags equal), both track refinements
    and traj_tracked."""
    js, ts = stages
    small_j = js["subsample"](jnp.asarray(clips))
    small_t = ts["subsample"](_t(clips))
    assert small_t.dtype == torch.float32 and small_t.shape == (3, 60, 72, 88)
    np.testing.assert_array_equal(_np(small_t), np.asarray(small_j))
    tr_j = [np.asarray(x) for x in jax.jit(js["traj"])(small_j)]
    tr_t = [_np(x) for x in ts["traj"](small_t)]
    np.testing.assert_array_equal(tr_t[2], tr_j[2])
    assert list(tr_t[2]) == [True, True, False]
    np.testing.assert_array_equal(tr_t[1], tr_j[1])
    np.testing.assert_allclose(tr_t[0], tr_j[0], rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(_np(ts["landmarks"](small_t)),
                               np.asarray(jax.jit(js["landmarks"])(small_j)), rtol=0, atol=TRAJ_ATOL)
    for name in ("track_refine", "track_refine_parallel"):
        want = [np.asarray(x) for x in jax.jit(js[name])(small_j, *[jnp.asarray(x) for x in tr_j])]
        got = [_np(x) for x in ts[name](small_t, *[_t(x) for x in tr_j])]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TRAJ_ATOL)
        np.testing.assert_array_equal(got[0][2], tr_j[0][2])  # the failed clip keeps its trajectory
    want = np.asarray(jax.jit(js["traj_tracked"])(small_j)[0])
    np.testing.assert_allclose(_np(ts["traj_tracked"](small_t)[0]), want, rtol=0, atol=TRAJ_ATOL)


def test_torch_staged_warp_stages_match_jax(clips, stages):
    """coords_from_traj (whole frames and a mouth window), traj_window and
    crop_window (int32 offsets equal), shift, coords, sample and warp on
    the JAX trajectory and landmarks."""
    js, ts = stages
    small_j = js["subsample"](jnp.asarray(clips))
    traj, face_w, _ok = [np.asarray(x) for x in jax.jit(js["traj"])(small_j)]
    lms = np.asarray(jax.jit(js["landmarks"])(small_j))
    h, w = clips.shape[-2:]
    for roi in (64, 96):
        x0w, y0w = [np.asarray(x) for x in js["traj_window"](jnp.asarray(traj), h, w, roi)]
        x0g, y0g = [_np(x) for x in ts["traj_window"](_t(traj), h, w, roi)]
        np.testing.assert_array_equal(x0g, x0w)
        np.testing.assert_array_equal(y0g, y0w)
        assert x0g.dtype == np.int32
        cw = [np.asarray(x) for x in js["crop_window"](jnp.asarray(lms), h, w, roi)]
        cg = [_np(x) for x in ts["crop_window"](_t(lms), h, w, roi)]
        np.testing.assert_array_equal(cg[0], cw[0])
        np.testing.assert_array_equal(cg[1], cw[1])
    np.testing.assert_allclose(_np(ts["shift"](_t(lms), _t(x0w), _t(y0w))),
                               np.asarray(js["shift"](jnp.asarray(lms), jnp.asarray(x0w),
                                                      jnp.asarray(y0w))), rtol=0, atol=1e-4)
    for off in (None, (x0w, y0w)):
        extra_j = () if off is None else tuple(jnp.asarray(o) for o in off)
        extra_t = () if off is None else tuple(_t(o) for o in off)
        ys_w, xs_w = js["coords_from_traj"](jnp.asarray(traj), jnp.asarray(face_w), *extra_j)
        ys_g, xs_g = ts["coords_from_traj"](_t(traj), _t(face_w), *extra_t)
        np.testing.assert_allclose(_np(ys_g), np.asarray(ys_w), rtol=0, atol=1e-4)
        np.testing.assert_allclose(_np(xs_g), np.asarray(xs_w), rtol=0, atol=1e-4)
    ys, xs = js["coords_from_traj"](jnp.asarray(traj), jnp.asarray(face_w))
    crops_w = np.asarray(js["sample"](jnp.asarray(clips), ys, xs))
    crops_g = _np(ts["sample"](_t(clips), _t(ys), _t(xs)))
    assert crops_g.shape == (3, 60, 96, 96)
    np.testing.assert_allclose(crops_g, crops_w, rtol=0, atol=CROP_ATOL)
    cj = [np.asarray(x) for x in jax.jit(js["coords"])(jnp.asarray(lms))]
    cg = [_np(x) for x in ts["coords"](_t(lms))]
    assert_crops_match(cg[0], cj[0], lms, 1e-3, axes="y")
    assert_crops_match(cg[1], cj[1], lms, 1e-3, axes="x")
    assert_crops_match(_np(ts["warp"](_t(clips[:, :8]), _t(lms[:, :8]))),
                       np.asarray(jax.jit(js["warp"])(jnp.asarray(clips[:, :8]),
                                                      jnp.asarray(lms[:, :8]))),
                       lms[:, :8], CROP_ATOL)


@pytest.mark.parametrize("roi", [96, None])
def test_torch_fused_frontend_matches_jax(clips, stages, roi):
    """The fused frontend against the JAX one (mouth-window offsets equal,
    crops compared with the knife-edge pixel undone), and against the
    port's own stages composed (exactly)."""
    js, ts = stages
    t = clips.shape[1]
    want = np.asarray(jax.jit(jp.make_lip_frontend(t, window=WINDOW, detect_ds=DS, roi=roi))(
        jnp.asarray(clips)))
    got = _np(tp.make_lip_frontend(t, window=WINDOW, detect_ds=DS, roi=roi)(_t(clips)))
    assert got.shape == (3, t, 96, 96)
    lms_j = np.asarray(jax.jit(js["landmarks"])(js["subsample"](jnp.asarray(clips))))
    lms_t = ts["landmarks"](ts["subsample"](_t(clips)))
    frames = _t(clips)
    if roi is not None:
        h, w = clips.shape[-2:]
        off_j = [np.asarray(x) for x in js["crop_window"](jnp.asarray(lms_j), h, w, roi)]
        off_t = ts["crop_window"](lms_t, h, w, roi)
        np.testing.assert_array_equal(_np(off_t[0]), off_j[0])
        np.testing.assert_array_equal(_np(off_t[1]), off_j[1])
        lms_j = np.asarray(js["shift"](jnp.asarray(lms_j), *[jnp.asarray(o) for o in off_j]))
        lms_t = ts["shift"](lms_t, *off_t)
        frames = torch.stack([f[:, y: y + roi, x: x + roi]
                              for f, x, y in zip(frames, *[o.tolist() for o in off_t])])
    np.testing.assert_array_equal(got, _np(ts["warp"](frames, lms_t)))
    assert_crops_match(got, want, lms_j, CROP_ATOL)
