"""AV-HuBERT inputs of the port against the JAX package (CPU, fp32): the
model card loader, the HTK filterbank, the 104-dim audio features, noise
mixing and ``AVHubertDataset``.

The log filterbank energies agree to 1e-4 in the log (1e-4 relative in
the energies): the port multiplies unfolded frames by the DFT basis where
XLA runs a strided convolution, so the fp32 sums run in other orders. The
committed golden (``tests/goldens/logfbank_golden.npz``, float64) is held
at the JAX test's own tolerance (``tests/test_audio_kernels.py``). Host
numpy code (the filterbank, ``add_noise``, the dataset's draws) is exact.
"""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.data.audio_segments import add_noise as jax_add_noise
from avsl_tpu.data.runtime import AVHubertDataset as JaxAVHubertDataset
from avsl_tpu.kernels import fbank as jax_fbank
from avsl_tpu.kernels import mel as jax_mel
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.data.audio_segments import add_noise, write_wav
from avsl_tpu_torch.data.runtime import AVHubertDataset
from avsl_tpu_torch.kernels import fbank, mel
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

LOG_TOL = dict(atol=1e-4, rtol=1e-4)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "logfbank_golden.npz")


def _audio(seconds=1.7, seed=0):
    """The golden's input: noise plus a 440 Hz tone (tests/test_audio_kernels.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.mark.parametrize("path", ["configs/avhubert_large.yaml"])
def test_torch_avhubert_config_from_yaml_matches_jax(path):
    """Every field of the model card as the JAX loader reads it; the
    concat fusion doubles the fused width."""
    root = os.path.dirname(os.path.dirname(__file__))
    want = JaxAVHuBERTConfig.from_yaml(os.path.join(root, path))
    got = AVHuBERTConfig.from_yaml(os.path.join(root, path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hidden_size, got.num_hidden_layers, got.decoder_attention_heads) == (1024, 24, 8)
    assert got.encoder_hidden_size == want.encoder_hidden_size == 2048
    assert got.to_dict() == want.to_dict()


def test_torch_htk_filterbank_is_a_copy():
    f = np.array([0.0, 300.0, 4000.0, 8000.0])
    np.testing.assert_array_equal(mel.hz_to_mel_htk(f), jax_mel.hz_to_mel_htk(f))
    m = mel.hz_to_mel_htk(f)
    np.testing.assert_array_equal(mel.mel_to_hz_htk(m), jax_mel.mel_to_hz_htk(m))
    for kw in ({}, dict(nfilt=40, nfft=1024, samplerate=16000, lowfreq=20.0, highfreq=7600.0)):
        np.testing.assert_array_equal(mel.mel_filterbank_htk_psf(**kw),
                                      jax_mel.mel_filterbank_htk_psf(**kw))


def test_torch_logfbank_matches_golden():
    with np.load(GOLDEN) as z:
        want = z["logfbank"]
    got = fbank.logfbank(_audio(), device="cpu").numpy()
    assert got.shape == want.shape == (169, 26)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-5)


@pytest.mark.parametrize("n", [300, 400, 401, 8000, 16000])
@pytest.mark.parametrize("batched", [False, True])
def test_torch_logfbank_matches_jax(n, batched):
    """Lengths at, under and past one frame; batched and not; a silent
    row hits the exact-zero floor."""
    rng = np.random.default_rng(n)
    audio = (0.2 * rng.standard_normal((3, n) if batched else (n,))).astype(np.float32)
    if batched:
        audio[1] = 0.0
    want = np.asarray(jax_fbank.logfbank(audio))
    got = fbank.logfbank(audio, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOG_TOL)


@pytest.mark.parametrize("t", [9, 12])
@pytest.mark.parametrize("stack", [1, 4])
def test_torch_stack_and_normalize_match_jax(t, stack):
    feats = np.random.default_rng(t).normal(size=(2, t, 26)).astype(np.float32)
    want = np.array(jax_fbank.stack_frames(feats, stack))
    got = fbank.stack_frames(torch.from_numpy(feats), stack).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fbank.stack_frames(torch.from_numpy(feats[0]), stack).numpy(),
                                  want[0])
    np.testing.assert_allclose(fbank.frame_normalize(torch.from_numpy(want)).numpy(),
                               np.asarray(jax_fbank.frame_normalize(want)), atol=1e-5, rtol=1e-5)


def test_torch_mfcc_and_deltas_match_jax():
    audio = _audio(0.8, seed=3)
    want = np.asarray(jax_fbank.mfcc(audio))
    got = fbank.mfcc(audio, device="cpu").numpy()
    assert got.shape == want.shape == (79, 13)
    # cepstra are linear in the log energies: the log tolerance scaled by
    # the DCT's and the lifter's gain
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(fbank.add_deltas(torch.from_numpy(want)).numpy(),
                               np.asarray(jax_fbank.add_deltas(want)), atol=1e-5, rtol=1e-5)
    batched = np.stack([want, want[::-1]])
    np.testing.assert_allclose(fbank.add_deltas(torch.from_numpy(batched), window=3).numpy(),
                               np.asarray(jax_fbank.add_deltas(batched, window=3)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_torch_avhubert_audio_features_match_jax(normalize):
    """The model's 104-dim input: 10 s of audio gives 250 frames at 25 Hz."""
    audio = (0.1 * np.random.default_rng(4).standard_normal(160000)).astype(np.float32)
    want = np.asarray(jax_fbank.avhubert_audio_features(audio, normalize=normalize))
    got = fbank.avhubert_audio_features(audio, normalize=normalize, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape == (250, 104)
    np.testing.assert_allclose(got.numpy(), want, **LOG_TOL)
    # a tensor input stays where it is; the batched path gives the same rows
    batched = fbank.avhubert_audio_features(torch.from_numpy(np.stack([audio, audio])),
                                            normalize=normalize)
    torch.testing.assert_close(batched[1], got, atol=0, rtol=0)


@pytest.mark.parametrize("snr_db", [0.0, 10.0, -5.0])
@pytest.mark.parametrize("noise_len", [500, 4000])
def test_torch_add_noise_matches_jax(snr_db, noise_len):
    """A short noise is tiled; a loud mix is divided by its peak."""
    rng = np.random.default_rng(int(noise_len + snr_db))
    clean = (0.5 * rng.standard_normal(2000)).astype(np.float32)
    noise = rng.standard_normal(noise_len).astype(np.float32)
    want = jax_add_noise(clean, noise, snr_db, np.random.default_rng(7))
    got = add_noise(clean, noise, snr_db, np.random.default_rng(7))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _lip_clip(path, n_frames, seed=0, size=96):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (size, size),
                             isColor=False)
    assert writer.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        writer.write(rng.integers(0, 256, (size, size), dtype=np.uint8))
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def av_rows(tmp_path_factory):
    """Rows with a 1 s wav and a 20-frame lip clip (the video is the
    shorter stream), rows without a clip, and a row of in-memory audio."""
    tmp = tmp_path_factory.mktemp("avh")
    rng = np.random.default_rng(0)
    wav = write_wav(str(tmp / "a.wav"), (0.1 * rng.standard_normal(16000)).astype(np.float32))
    clip = _lip_clip(tmp / "a-lip.mp4", 20)
    rows = [{"audio": wav, "lip_video": clip, "transcript": f"t{i}"} for i in range(8)]
    rows += [{"audio": wav, "transcript": "audio only"} for _ in range(3)]
    rows.append({"audio": {"array": (0.1 * rng.standard_normal(12000)).astype(np.float32),
                           "sampling_rate": 16000}})
    return rows


@pytest.mark.parametrize("train,epoch,noise", [(False, 0, False), (True, 0, False),
                                               (True, 1, False), (True, 0, True)])
def test_torch_avhubert_dataset_matches_jax(av_rows, train, epoch, noise):
    """Item by item on the same rows and seeds: the drop draws, the
    at-least-one fallback, presence flags, truncate-to-min lengths and
    the lip frames exactly; the audio features at the log tolerance (the
    port's features are its own fbank, exactly)."""
    noise_audio = np.random.default_rng(9).standard_normal(3000).astype(np.float32)
    kw = dict(audio_drop_prob=0.5, video_drop_prob=0.4, train=train, seed=5,
              add_noise_prob=0.7 if noise else 0.0,
              noise_audio=noise_audio if noise else None, noise_snr_db=5.0)
    jds, pds = JaxAVHubertDataset(av_rows, **kw), AVHubertDataset(av_rows, **kw)
    jds.set_epoch(epoch)
    pds.set_epoch(epoch)
    assert len(pds) == len(jds) == len(av_rows)
    flags = []
    for i in range(len(av_rows)):
        want, got = jds[i], pds[i]
        assert sorted(got) == sorted(want)
        for key in ("audio_present", "video_present"):
            assert got[key] == want[key], (i, key)
        assert got.get("transcript") == want.get("transcript")
        np.testing.assert_array_equal(got["video_feats"], want["video_feats"])
        assert got["audio_feats"].shape == want["audio_feats"].shape
        np.testing.assert_allclose(got["audio_feats"], want["audio_feats"], **LOG_TOL)
        assert got["audio_present"] + got["video_present"] >= 1.0
        flags.append((got["audio_present"], got["video_present"]))
    assert pds[0]["audio_feats"].shape[0] == 20  # the clip's 20 frames, not the audio's 25
    assert all(v == 0.0 and a == 1.0 for a, v in flags[8:])  # no clip: audio kept
    if train:  # not vacuous: both streams get dropped somewhere
        assert min(a for a, _ in flags) == 0.0 and min(v for _, v in flags[:8]) == 0.0
    else:
        assert all(f == (1.0, 1.0) for f in flags[:8])
