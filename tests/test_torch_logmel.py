"""Port log-mel front end against avsl_tpu.kernels.log_mel_spectrogram (CPU).

atol 5e-5, rtol 1e-5: the precedent of tests/test_audio_kernels.py; the
port's framed matmul sums the DFT in another order than XLA's conv.
"""

import numpy as np
import pytest
import torch

from avsl_tpu.kernels import log_mel_spectrogram as jax_log_mel
from avsl_tpu.kernels.mel import mel_filterbank_slaney as jax_mel_filterbank
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram, pad_or_trim
from avsl_tpu_torch.kernels.mel import mel_filterbank_slaney


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("batched", [False, True])
def test_torch_log_mel_matches_jax(n_mels, batched):
    rng = np.random.default_rng(n_mels)
    shape = (3, 8000) if batched else (8000,)
    audio = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jax_log_mel(audio, n_mels=n_mels, padding=4800))
    got = log_mel_spectrogram(audio, n_mels=n_mels, padding=4800, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_torch_mel_filterbank_is_a_copy(n_mels):
    np.testing.assert_array_equal(mel_filterbank_slaney(n_mels=n_mels),
                                  jax_mel_filterbank(n_mels=n_mels))


@pytest.mark.parametrize("n", [10, 16, 23])
def test_torch_pad_or_trim_numpy_and_tensor(n):
    x = np.arange(n, dtype=np.float32)
    want = np.pad(x, (0, max(16 - n, 0)))[:16]
    np.testing.assert_array_equal(pad_or_trim(x, 16), want)
    np.testing.assert_array_equal(pad_or_trim(torch.from_numpy(x), 16).numpy(), want)
