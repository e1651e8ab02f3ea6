"""Port of data/landmarks.py (without the CNN) against the JAX package.

The device functions (``_box_blur_t``, ``_device_maps_fn``,
``_device_detect_fn``) against ``_box_blur_jnp``, ``_device_maps_fn`` and
``_device_detect_fn`` (jitted, vmapped): maps within 1e-3 (fp32 prefix
sums in another order); the detections' ok flags equal, the face width
equal and the mouth within 1e-3 px. ``kernels/stats.py`` against
``jnp.median``/``nanmedian``/``nanquantile``, an even count pinned. The
host detectors are numpy on both sides and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsl_tpu.data import landmarks as jl
from avsl_tpu_torch.data import landmarks as tl
from avsl_tpu_torch.kernels import stats
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_lip_fixtures import DS, WINDOW, closeup_clips, face_clip

# box blurs: differences of fp32 prefix sums that reach 3.3e3 (a float32
# ulp there is 2.4e-4), in another order than XLA's
BLUR_TOL = dict(rtol=1e-4, atol=1e-3)
MOUTH_ATOL = 1e-3


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def small():
    """The detection stream of three 60-frame closeups (two windows of 25)
    at DS: two moving heads and one static clip (no detection)."""
    clips = closeup_clips(b=3, t=60)
    clips[2] = clips[2, :1]
    return np.ascontiguousarray(clips[:, :, ::DS, ::DS]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 11, 25])
def test_torch_box_blur_matches_jax_and_numpy(k):
    x = np.random.default_rng(k).uniform(0, 50, (2, 3, 30, 41)).astype(np.float32)
    want = np.asarray(jax.jit(jl._box_blur_jnp, static_argnums=1)(jnp.asarray(x), k))
    got = _np(tl._box_blur_t(torch.from_numpy(x), k))
    np.testing.assert_allclose(got, want, **BLUR_TOL)
    if k > 1:
        np.testing.assert_allclose(got[1, 2], tl._box_blur(x[1, 2], k), **BLUR_TOL)


def test_torch_device_maps_match_jax(small):
    want = jl._device_maps_fn(WINDOW, 11, 64)(jnp.asarray(small))
    got = tl._device_maps_fn(WINDOW, 11, 64)(torch.from_numpy(small))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[2].shape[1] == 2  # two windows
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **BLUR_TOL)
    short = small[:, :20]  # fewer frames than a window: the clip maps stand in
    got_s = tl._device_maps_fn(WINDOW, 11, 64)(torch.from_numpy(short))
    np.testing.assert_allclose(_np(got_s[2][:, 0]), _np(got_s[0]))


def test_torch_device_detect_matches_jax(small):
    """Clip and window detections on the same maps: ok flags equal (two
    clips detected, the static one not), face widths equal, mouths within
    MOUTH_ATOL px."""
    cm, ca, wm, wa = jl._device_maps_fn(WINDOW, 11, 64)(jnp.asarray(small))
    base = jl.MotionEnergyDetector()
    jdet = jax.jit(jax.vmap(jl._device_detect_fn(base.keep_mass, base.center_sigma, base.min_box,
                                                 base.close_k)))
    tdet = tl._device_detect_fn(base.keep_mass, base.center_sigma, base.min_box, base.close_k)
    for m, a in ((cm, ca), (wm.reshape(-1, *wm.shape[2:]), wa.reshape(-1, *wa.shape[2:]))):
        want = np.asarray(jdet(m, a))
        got = _np(tdet(torch.from_numpy(np.asarray(m)), torch.from_numpy(np.asarray(a))))
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
        np.testing.assert_array_equal(got[:, 2], want[:, 2])
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=MOUTH_ATOL)
    assert list(_np(tdet(torch.from_numpy(np.asarray(cm)), torch.from_numpy(np.asarray(ca))))[:, 3]) \
        == [1.0, 1.0, 0.0]


def test_torch_quantiles_match_jnp_even_count():
    """An even count: jnp's median is the midpoint of the two middle values
    (torch.median returns the lower one), in both the plain and the NaN
    form; nanquantile(0.9) is the linear method."""
    x = np.array([[3.0, 1.0, 4.0, 1.5, 9.0, 2.6], [5.0, 3.5, 8.0, 9.7, 9.3, 2.4]], np.float32)
    want = np.asarray(jnp.median(jnp.asarray(x), axis=-1))
    got = _np(stats.median(torch.from_numpy(x), dim=-1))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, _np(torch.from_numpy(x).median(dim=-1).values))
    xn = x.copy()
    xn[0, 1], xn[1, :] = np.nan, np.nan
    xn[1, 2:4] = (1.0, 2.5)
    np.testing.assert_array_equal(_np(stats.nanmedian(torch.from_numpy(xn), dim=-1)),
                                  np.asarray(jnp.nanmedian(jnp.asarray(xn), axis=-1)))
    np.testing.assert_array_equal(_np(stats.nanquantile(torch.from_numpy(xn), 0.9, dim=-1)),
                                  np.asarray(jnp.nanquantile(jnp.asarray(xn), 0.9, axis=-1)))
    allnan = np.full((1, 4), np.nan, np.float32)
    assert np.isnan(_np(stats.nanmedian(torch.from_numpy(allnan)))).all()
    y = np.random.default_rng(0).normal(size=(3, 10, 2)).astype(np.float32)  # NW = 10 windows
    np.testing.assert_array_equal(_np(stats.median(torch.from_numpy(y), dim=1)),
                                  np.asarray(jnp.median(jnp.asarray(y), axis=1)))


def test_torch_host_detectors_match_jax_exactly():
    """EnergyBoxDetector, MotionEnergyDetector (per clip and per window),
    canonical_landmarks_from_box, AnchorTrackDetector and
    PrecomputedLandmarks: the same numpy (and OpenCV) on both sides."""
    frames = closeup_clips(b=1, t=60)[0, :, ::DS, ::DS]
    face, _ = face_clip(t=30)
    pairs = [
        (jl.EnergyBoxDetector(every_n=3), tl.EnergyBoxDetector(every_n=3), frames),
        (jl.MotionEnergyDetector(), tl.MotionEnergyDetector(), frames),
        (jl.AnchorTrackDetector(), tl.AnchorTrackDetector(), face),
    ]
    for jd, td, f in pairs:
        want, got = jd(f), td(f)
        assert len(got) == len(want) == len(f)
        assert any(w is not None for w in want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g, w)
    assert jl.MotionEnergyDetector().detect_clip(frames) == tl.MotionEnergyDetector().detect_clip(frames)
    np.testing.assert_array_equal(tl.canonical_landmarks_from_box(10, 20, 60, 70),
                                  jl.canonical_landmarks_from_box(10, 20, 60, 70))
    lms = [None, np.ones((68, 2), np.float32)]
    assert tl.PrecomputedLandmarks(lms)(np.zeros((2, 4, 4))) == lms


def test_torch_batched_detector_matches_jax(small):
    """BatchedMotionDetector on the CPU, device logic on and off, against
    the JAX one: the same per-clip landmark lists within 1e-2 px (the
    window mouths differ by float rounding, times DS)."""
    clips = closeup_clips(b=3, t=60)
    clips[2] = clips[2, :1]
    for device_logic in (True, False):
        want = jl.BatchedMotionDetector(window=WINDOW, downsample=DS,
                                        device_logic=device_logic)(clips)
        got = tl.BatchedMotionDetector(window=WINDOW, downsample=DS, device_logic=device_logic,
                                       device="cpu")(clips)
        for per_g, per_w in zip(got, want):
            assert [g is None for g in per_g] == [w is None for w in per_w]
            for g, w in zip(per_g, per_w):
                if w is not None:
                    np.testing.assert_allclose(g, w, rtol=0, atol=1e-2)
        assert all(w is None for w in want[2]) and any(w is not None for w in want[0])


def test_torch_create_detector():
    assert isinstance(tl.create_detector("motion"), tl.MotionEnergyDetector)
    assert isinstance(tl.create_detector("energy", every_n=2), tl.EnergyBoxDetector)
    assert isinstance(tl.create_detector("anchor_track"), tl.AnchorTrackDetector)
    from avsl_tpu_torch.data.lip_refine import RefinedMouthTracker

    assert isinstance(tl.create_detector("refined"), RefinedMouthTracker)
    assert isinstance(tl.create_detector("cnn", device="cpu"), tl.CNNLandmarkDetector)
    with pytest.raises(ValueError):
        tl.create_detector("dlib")
