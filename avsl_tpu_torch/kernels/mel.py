"""Mel filterbanks (host-side numpy; the matrices feed the log-mel and
log-fbank products on the device).

A copy of ``avsl_tpu/kernels/mel.py``: the Slaney triangular filters with
area normalisation that ``librosa.filters.mel(sr, n_fft, n_mels,
norm="slaney", htk=False)`` builds and Whisper ships as its mel_filters
asset, and the HTK filters with integer-bin corners of
``python_speech_features.get_filterbanks`` that the AV-HuBERT audio
features use.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # = 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )
    return mel


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)
    return f


def mel_filterbank_slaney(
    sr: int = 16000,
    n_fft: int = 400,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank with Slaney area normalization,
    ``[n_mels, 1 + n_fft//2]`` float32."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# HTK mel with integer-bin snapping (python_speech_features.get_filterbanks)
# ---------------------------------------------------------------------------


def hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank_htk_psf(
    nfilt: int = 26,
    nfft: int = 512,
    samplerate: int = 16000,
    lowfreq: float = 0.0,
    highfreq: float | None = None,
) -> np.ndarray:
    """Filterbank of ``python_speech_features.get_filterbanks``: triangle
    corners snapped to integer FFT bins by ``floor((nfft+1) * hz /
    samplerate)``, triangles built per bin on those corners, no area
    normalisation. ``[nfilt, nfft//2 + 1]`` float64."""
    highfreq = highfreq or samplerate / 2.0
    melpoints = np.linspace(hz_to_mel_htk(lowfreq), hz_to_mel_htk(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel_to_hz_htk(melpoints) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1), dtype=np.float64)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank
