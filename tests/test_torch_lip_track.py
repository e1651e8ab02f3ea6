"""Port of the NCC trackers against the JAX package (CPU).

``kernels/track.py``: ``ncc_scores`` within 1e-4 (float32 correlations of
2,304 products in another order), and the anchored, frame-0 and parallel
trackers on a textured patch moving over a noisy background: positions
equal on at least 95 % of the frames and within 2 px on all (the score
maps agree within 1e-4, so near-ties between neighbouring offsets may
resolve the other way; the sequential tracker carries a changed position
into its next search window). ``data/track_host.py`` and
``kernels/track_native.py`` are numpy, OpenCV and the shared C++ library
on both sides: equal exactly, on the OpenCV and on the numpy path.
``kernels/warp_native.py`` likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsl_tpu.data import track_host as j_host
from avsl_tpu.kernels import track as jt
from avsl_tpu.kernels import track_native as j_native
from avsl_tpu.kernels import warp_native as j_warp_native
from avsl_tpu_torch.data import track_host as t_host
from avsl_tpu_torch.kernels import track as tt
from avsl_tpu_torch.kernels import track_native as t_native
from avsl_tpu_torch.kernels import warp_native as t_warp_native
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)
from torch_native_fixtures import load_jax_native

SAME_FRACTION = 0.95
TRACK_ATOL = 2.0


def _tracking_clips(b=2, t=40, h=90, w=110, seed=5):
    """Textured patches moving on smooth paths over noisy backgrounds
    (tests/test_host_crops.py's construction), uint8 [b, t, h, w]."""
    rng = np.random.default_rng(seed)
    clips = np.empty((b, t, h, w), np.uint8)
    for bi in range(b):
        bg = rng.integers(0, 60, (h, w)).astype(np.float32)
        patch = rng.integers(100, 255, (14, 14)).astype(np.float32)
        path = np.stack([28 + (0.9 + 0.2 * bi) * np.arange(t), 40 + 6 * np.sin(np.arange(t) / 9 + bi)], -1)
        for i in range(t):
            f = bg.copy()
            x, y = int(path[i, 0]), int(path[i, 1])
            f[y: y + 14, x: x + 14] = patch
            clips[bi, i] = f.astype(np.uint8)
    return clips


def _assert_tracks_close(got, want):
    same = np.all(got == want, axis=-1).mean()
    assert same >= SAME_FRACTION, f"{same:.3f} of the frames equal"
    np.testing.assert_allclose(got, want, rtol=0, atol=TRACK_ATOL)


def test_torch_ncc_scores_match_jax():
    clips = _tracking_clips(b=1)
    window = clips[0, 7, 20:70, 30:90]
    template = clips[0, 3, 38:54, 30:46]
    want = np.asarray(jax.jit(jt.ncc_scores)(jnp.asarray(window), jnp.asarray(template)))
    got = tt.ncc_scores(torch.from_numpy(window), torch.from_numpy(template)).numpy()
    assert got.shape == (35, 45)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("anchor", [0, 20])
def test_torch_anchored_trackers_match_jax(anchor):
    """The sequential tracker from frame 0 (``ncc_track_clip``/``_batch``)
    and from a mid-clip anchor, clip by clip and batched."""
    clips = _tracking_clips()
    pos = np.array([[35.0, 47.0], [52.0, 44.0]], np.float32) if anchor == 0 else \
        np.array([[53.0, 43.0], [60.0, 40.0]], np.float32)
    kw = dict(template_size=16, search=8)
    want = np.asarray(jt.ncc_track_batch_anchored(jnp.asarray(clips), jnp.asarray(pos), anchor, **kw))
    got = tt.ncc_track_batch_anchored(torch.from_numpy(clips), torch.from_numpy(pos), anchor,
                                      **kw).numpy()
    assert got.shape == (2, 40, 2)
    _assert_tracks_close(got, want)
    one = tt.ncc_track_clip_anchored(torch.from_numpy(clips[1]), torch.from_numpy(pos[1]), anchor,
                                     **kw).numpy()
    np.testing.assert_array_equal(one, got[1])
    if anchor == 0:
        w0 = np.asarray(jt.ncc_track_clip(jnp.asarray(clips[0]), jnp.asarray(pos[0]), **kw))
        _assert_tracks_close(tt.ncc_track_clip(torch.from_numpy(clips[0]), torch.from_numpy(pos[0]),
                                               **kw).numpy(), w0)
        wb = np.asarray(jt.ncc_track_batch(jnp.asarray(clips), jnp.asarray(pos), **kw))
        _assert_tracks_close(tt.ncc_track_batch(torch.from_numpy(clips), torch.from_numpy(pos),
                                                **kw).numpy(), wb)


def test_torch_parallel_tracker_matches_jax():
    """The scan-free tracker, one search radius that fits and one shrunk
    to the frame; and the host twin, which is held to the JAX device
    tracker by the JAX package's own tests."""
    clips = _tracking_clips()
    pos = np.array([[53.0, 43.0], [60.0, 40.0]], np.float32)
    for search in (20, 80):
        kw = dict(template_size=16, search=search)
        want = np.asarray(jt.ncc_track_batch_parallel(jnp.asarray(clips), jnp.asarray(pos), 20, **kw))
        got = tt.ncc_track_batch_parallel(torch.from_numpy(clips), torch.from_numpy(pos), 20,
                                          **kw).numpy()
        _assert_tracks_close(got, want)
        one = tt.ncc_track_clip_parallel(torch.from_numpy(clips[0]), torch.from_numpy(pos[0]), 20,
                                         **kw).numpy()
        np.testing.assert_array_equal(one, got[0])
        host = t_host.ncc_track_clip_parallel_np(clips[0], pos[0], 20, **kw)
        _assert_tracks_close(got[0], host)


@pytest.mark.parametrize("use_cv2", [True, False])
def test_torch_track_host_matches_jax(monkeypatch, use_cv2):
    """Per-frame argmax, strided with interpolation, and top-k Viterbi."""
    if use_cv2 and not t_host._HAS_CV2:
        pytest.skip("OpenCV is not installed")
    monkeypatch.setattr(t_host, "_HAS_CV2", use_cv2)
    monkeypatch.setattr(j_host, "_HAS_CV2", use_cv2)
    clips = _tracking_clips(b=1)
    for kw in (dict(), dict(stride=3), dict(top_k=3, motion_lambda=0.05)):
        want = j_host.ncc_track_clip_parallel_np(clips[0], np.array([53.0, 43.0]), 20,
                                                 template_size=16, search=30, **kw)
        got = t_host.ncc_track_clip_parallel_np(clips[0], np.array([53.0, 43.0]), 20,
                                                template_size=16, search=30, **kw)
        np.testing.assert_array_equal(got, want)
    got = t_host.ncc_track_batch_parallel_np(clips, np.array([[53.0, 43.0]]), 20, template_size=16)
    np.testing.assert_array_equal(got, j_host.ncc_track_batch_parallel_np(
        clips, np.array([[53.0, 43.0]]), 20, template_size=16))


@pytest.mark.parametrize("prefer", ["auto", "native"])
def test_torch_native_tracker_matches_jax(prefer):
    """ncc_track_batch_host at ds 2 with stride and top-k, a clip too small
    for the search window (ok False), through the library when it is
    built (``prefer="native"``) and OpenCV's wheel (``"auto"``)."""
    clips = np.concatenate([_tracking_clips(b=2, h=120, w=140),
                            np.zeros((1, 40, 120, 140), np.uint8)])
    small = np.zeros((1, 40, 30, 30), np.uint8)
    pos = np.array([[28.0, 22.0], [30.0, 21.0], [30.0, 30.0]], np.float32)
    kw = dict(ds=2, template_size=16, search=24, stride=2, top_k=3, prefer=prefer)
    assert t_native.native_available() == (load_jax_native(j_native, "avsl_track") is not None)
    want, ok_w = j_native.ncc_track_batch_host(clips, pos, 20, **kw)
    got, ok_g = t_native.ncc_track_batch_host(clips, pos, 20, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok_g, ok_w)
    got_s, ok_s = t_native.ncc_track_batch_host(small, pos[:1], 20, **kw)
    assert not ok_s[0] and np.array_equal(got_s[0], np.broadcast_to(pos[0], (40, 2)))


def test_torch_native_sampler_matches_jax():
    """warp_native: the library (when built) and the numpy twin, uint8 and
    float32 outputs, float frames on the numpy path, and the batch check."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 11, 61, 77), np.uint8)
    ys = rng.uniform(-3, 64, (2, 11, 32)).astype(np.float32)
    xs = rng.uniform(-3, 80, (2, 11, 32)).astype(np.float32)
    assert t_warp_native.native_available() == (load_jax_native(j_warp_native, "avsl_warp") is not None)
    for dt in (np.uint8, np.float32):
        np.testing.assert_array_equal(t_warp_native.sample_separable_host(frames, ys, xs, out_dtype=dt),
                                      j_warp_native.sample_separable_host(frames, ys, xs, out_dtype=dt))
    np.testing.assert_array_equal(t_warp_native.sample_separable_np(frames, ys, xs),
                                  j_warp_native.sample_separable_np(frames, ys, xs))
    f32 = frames.astype(np.float32)
    np.testing.assert_array_equal(t_warp_native.sample_separable_host(f32, ys, xs),
                                  j_warp_native.sample_separable_host(f32, ys, xs))
    with pytest.raises(ValueError):
        t_warp_native.sample_separable_host(frames, ys[:1], xs)


def test_torch_native_build_skips_when_asked(tmp_path, monkeypatch):
    """ensure_built runs make only when the target is missing or stale, and
    not at all under AVSL_NO_NATIVE_BUILD=1."""
    from avsl_tpu_torch.utils.native_build import ensure_built

    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    (src / "Makefile").write_text("TARGET := out.so\n$(TARGET):\n\ttouch $@\n")
    monkeypatch.setenv("AVSL_NO_NATIVE_BUILD", "1")
    ensure_built(str(src), "out.so", out_dir=str(out))
    assert not (out / "out.so").exists()
    monkeypatch.delenv("AVSL_NO_NATIVE_BUILD")
    assert ensure_built(str(src), "out.so", out_dir=str(out)) == str(out / "out.so")
    assert (out / "out.so").exists() and not (src / "out.so").exists()
