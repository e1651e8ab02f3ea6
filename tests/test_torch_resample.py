"""The port's polyphase resampler and the audio readers that call it (CPU).

``avsl_tpu_torch.kernels.resample.resample_poly`` against
``avsl_tpu.kernels.resample.resample_poly`` (atol 1e-5: both sum the same
fp32 products in other orders) and ``scipy.signal.resample_poly`` (atol
1e-4, as ``tests/test_audio_kernels.py``: scipy filters in float64) at 44.1,
48, 22.05 and 8 kHz to 16 kHz, on 1-D input, ``[B, N]`` input and input
shorter than the filter; the filter taps bit for bit; equal rates return
the input itself; the zero-stuffed signal is never allocated. ``load_wav``
and ``_extract_audio`` on a 44.1 kHz int16 wav, wav bytes and a 48 kHz
array row, port against JAX.
"""

import io

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import scipy.signal
import torch

from avsl_tpu.data.audio_segments import load_wav as jax_load_wav
from avsl_tpu.data.runtime import _extract_audio as jax_extract_audio
from avsl_tpu.kernels.resample import _design_filter as jax_design_filter
from avsl_tpu.kernels.resample import resample_poly as jax_resample_poly
from avsl_tpu_torch.data.audio_segments import load_wav
from avsl_tpu_torch.data.runtime import _extract_audio
from avsl_tpu_torch.kernels.resample import _design_filter, resample_poly
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

RATES = (44100, 48000, 22050, 8000)
# 1-D of 0.3 s, [B, N] of 0.1 s, and 1-D shorter than the filter (8,821
# taps at 44.1 kHz, 321 at 8 kHz)
SHAPES = {"1d": lambda sr: (int(0.3 * sr),), "batch": lambda sr: (3, int(0.1 * sr)),
          "short": lambda sr: (37,)}


def _signal(shape, seed=0):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("sr", RATES)
def test_torch_resample_matches_jax_and_scipy(sr, shape):
    x = _signal(SHAPES[shape](sr))
    got = resample_poly(x, sr, 16000)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want_jax = np.asarray(jax_resample_poly(x, sr, 16000))
    want_scipy = scipy.signal.resample_poly(x, 16000, sr, axis=-1)
    assert got.shape == want_jax.shape == want_scipy.shape
    assert got.shape[-1] == -(-x.shape[-1] * 16000 // sr)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_scipy, atol=1e-4, rtol=0)


@pytest.mark.parametrize("sr", RATES)
def test_torch_resample_filter_taps_bit_identical(sr):
    g = np.gcd(sr, 16000)
    up, down = 16000 // g, sr // g
    taps, ref = _design_filter(up, down), jax_design_filter(up, down)
    assert taps.dtype == np.float32 and len(taps) == 20 * max(up, down) + 1
    np.testing.assert_array_equal(taps, ref)


def test_torch_resample_identity_and_tensor_input():
    x = torch.from_numpy(_signal((2, 500)))
    assert resample_poly(x, 16000, 16000) is x
    # a tensor in, the same numbers as the numpy path
    np.testing.assert_array_equal(resample_poly(x, 48000, 16000).numpy(),
                                  resample_poly(x.numpy(), 48000, 16000).numpy())


def test_torch_resample_never_builds_the_zero_stuffed_signal():
    """10 s at 44.1 kHz: zero-stuffing by 160 would allocate 282 MB. The
    largest allocation of the polyphase path is its gathered windows,
    ``ceil(8821 / 160) = 56`` inputs for each of the 160,000 outputs (36
    MB)."""
    x = _signal((441000,))
    stuffed_bytes = 441000 * 160 * 4
    windows_bytes = 160000 * 56 * 4
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        out = resample_poly(x, 44100, 16000)
    assert out.shape == (160000,)
    largest = max(e.cpu_memory_usage for e in prof.key_averages())
    assert 0 < largest <= windows_bytes < stuffed_bytes / 7


def test_torch_load_wav_resamples_like_jax(tmp_path):
    path = str(tmp_path / "a44.wav")
    pcm = (_signal((22050,), seed=1) * 20000).astype(np.int16)
    wavfile.write(path, 44100, pcm)
    got, want = load_wav(path), jax_load_wav(path)
    assert got.dtype == np.float32 and got.shape == want.shape == (8000,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with open(path, "rb") as f:
        row = {"audio": {"bytes": f.read(), "path": "a44.wav"}}  # save_to_disk's cell
    np.testing.assert_allclose(_extract_audio(row), jax_extract_audio(row), atol=1e-5, rtol=0)


def test_torch_extract_audio_resamples_array_rows_like_jax():
    pcm = (_signal((4800,), seed=2) * 20000).astype(np.int16)
    row = {"audio": {"array": pcm, "sampling_rate": 48000}}
    got, want = _extract_audio(row), jax_extract_audio(row)
    assert got.dtype == np.float32 and got.shape == want.shape == (1600,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    at16 = {"audio": {"array": _signal((1600,), seed=3), "sampling_rate": 16000}}
    np.testing.assert_array_equal(_extract_audio(at16), jax_extract_audio(at16))
    buf = io.BytesIO()
    wavfile.write(buf, 16000, pcm[:1600])
    cell = {"audio": {"bytes": buf.getvalue(), "path": None}}
    np.testing.assert_array_equal(_extract_audio(cell), jax_extract_audio(cell))
