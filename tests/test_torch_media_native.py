"""The port's binding of the native media runtime (``cpp/avsl_media``)
against the JAX package's binding and the port's OpenCV paths (CPU).

The cases of ``tests/test_media_native.py`` through
``avsl_tpu_torch.data.media_native``: the library is built on demand and
the module skips where it cannot be built (no libav headers). A seeded
clip written with OpenCV stands in for the AMI example: the native decode
against the port's ``read_video_frames`` (mean difference under 3 grey
levels, the JAX test's bound), the batch decode, a resized and capped
decode, a time window; audio decode and resampling, batch audio, and an
error on a missing file. Every result equals the JAX binding's on the
same library. The cv2 path taken without the library (``_load_lib``
returning None) gives the port's ``read_video_frames`` exactly.
"""

import os
import subprocess

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from avsl_tpu.data import media_native as jax_mn
from avsl_tpu_torch.data import media_native as mn
from avsl_tpu_torch.data.video_io import read_video_frames, write_video_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    so = os.path.join(REPO, "cpp", "avsl_media", "libavsl_media.so")
    if not os.path.exists(so):
        r = subprocess.run(["make", "-C", os.path.join(REPO, "cpp", "avsl_media")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"cannot build native module: {r.stderr[-500:]}")
    mn._load_lib.cache_clear()
    jax_mn._load_lib.cache_clear()
    if not mn.native_available():
        pytest.skip("native module unavailable")
    return mn


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A seeded 40-frame 120 x 160 grey clip written as mp4 at 25 fps."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:120, 0:160]
    frames = np.stack([np.clip(100 + 60 * np.sin((xx + 3 * t) / 9.0) * np.cos(yy / 7.0)
                               + rng.normal(0, 5, (120, 160)), 0, 255)
                       for t in range(40)]).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    write_video_frames(path, frames, fps=25)
    return path


def test_torch_audio_decode_resample(native, tmp_path):
    sr0 = 44100
    t = np.arange(sr0 * 2) / sr0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    p = str(tmp_path / "tone.wav")
    wavfile.write(p, sr0, (x * 32767).astype(np.int16))

    audio, sr = native.decode_audio(p, target_sr=16000)
    assert sr == 16000
    assert abs(len(audio) - 32000) < 100
    peak = np.abs(np.fft.rfft(audio[:16000])).argmax()
    assert abs(peak - 440) <= 2
    want, want_sr = jax_mn.decode_audio(p, target_sr=16000)
    np.testing.assert_array_equal(audio, want)

    batch, counts = native.decode_audio_batch([p] * 4, max_samples=32000)
    assert batch.shape == (4, 32000)
    assert (counts == 32000).all()
    np.testing.assert_array_equal(batch, jax_mn.decode_audio_batch([p] * 4, max_samples=32000)[0])


def test_torch_audio_decode_error(native):
    with pytest.raises(IOError):
        native.decode_audio("/nonexistent/file.wav")


def test_torch_video_decode_matches_cv2(native, clip):
    frames = native.decode_video_gray(clip)
    cvf = read_video_frames(clip, grayscale=True)
    assert frames.shape == cvf.shape
    diff = np.abs(frames.astype(float) - cvf.astype(float)).mean()
    assert diff < 3.0, diff
    np.testing.assert_array_equal(frames, jax_mn.decode_video_gray(clip))
    window = native.decode_video_gray(clip, start_sec=0.4, end_sec=0.8)
    assert len(window) == 10
    np.testing.assert_array_equal(window, jax_mn.decode_video_gray(clip, start_sec=0.4,
                                                                   end_sec=0.8))


def test_torch_video_batch_decode(native, clip):
    arena, counts = native.decode_video_batch([clip] * 4, out_size=(80, 60), max_frames=30)
    assert arena.shape == (4, 30, 60, 80)
    assert (counts == 30).all()
    np.testing.assert_array_equal(arena[0], arena[3])
    np.testing.assert_array_equal(
        arena, jax_mn.decode_video_batch([clip] * 4, out_size=(80, 60), max_frames=30)[0])


def test_torch_video_decode_resized_and_capped(native, clip):
    frames = native.decode_video_gray(clip, max_frames=10, out_size=(96, 96))
    assert frames.shape == (10, 96, 96)


def test_torch_cv2_path_without_the_library(clip, monkeypatch):
    """With no library the decode is OpenCV's on the host, as in JAX: the
    port's ``read_video_frames``, its time window by frame index, and the
    batch arena; compressed audio has no such path and raises."""
    import cv2

    monkeypatch.setattr(mn, "_load_lib", lambda: None)
    monkeypatch.setattr(jax_mn, "_load_lib", lambda: None)
    assert not mn.native_available()
    want = read_video_frames(clip, grayscale=True)
    np.testing.assert_array_equal(mn.decode_video_gray(clip), want)
    np.testing.assert_array_equal(mn.decode_video_gray(clip, start_sec=0.4, end_sec=0.8),
                                  want[10:20])
    resized = mn.decode_video_gray(clip, max_frames=5, out_size=(64, 48))
    np.testing.assert_array_equal(resized, np.stack([cv2.resize(f, (64, 48)) for f in want[:5]]))
    arena, counts = mn.decode_video_batch([clip, "/nonexistent.mp4"], (64, 48), 8)
    assert list(counts) == [8, -1]
    want_arena, want_counts = jax_mn.decode_video_batch([clip, "/nonexistent.mp4"], (64, 48), 8)
    np.testing.assert_array_equal(arena, want_arena)
    np.testing.assert_array_equal(counts, want_counts)
    with pytest.raises(RuntimeError, match="not built"):
        mn.decode_audio(clip)


def test_torch_unloadable_library_counts_as_absent(monkeypatch):
    """A library built on another machine whose libav shared libraries are
    missing here fails to load: the binding takes the OpenCV path."""
    def refuse(path, *a, **k):
        raise OSError(f"{path}: libavformat.so: cannot open shared object file")

    monkeypatch.setattr(mn.ctypes, "CDLL", refuse)
    monkeypatch.setattr(mn.os.path, "exists", lambda p: True)
    monkeypatch.setenv("AVSL_NO_NATIVE_BUILD", "1")
    mn._load_lib.cache_clear()
    try:
        assert not mn.native_available()
    finally:
        mn._load_lib.cache_clear()
