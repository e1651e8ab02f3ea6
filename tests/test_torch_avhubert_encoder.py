"""AV-HuBERT fusion encoder of the port against the JAX package on carried
weights (CPU, fp32): ``AVHuBERTEncoderWrapper`` in each fusion mode
(``concat``, ``add``, ``weighted_sum``) with the presence flags [1, 1],
[1, 0] and [0, 1], with and without padding; a missing stream, the
truncation of the streams to the shorter, and the feature and channel
masks. Carriers and tolerances are those of
``tests/test_torch_avhubert_models.py`` (atol 1e-5 + rtol 1e-4).
"""

import numpy as np
import pytest
import torch

from avsl_tpu.models.avhubert import AVHuBERTForSpeech2Text as JaxS2T
from avsl_tpu.models.layers import fairseq_sinusoid_embedding as jax_fairseq_sinusoid
from avsl_tpu_torch.models.layers import fairseq_sinusoid_embedding
from test_torch_avhubert_models import B, T, av_inputs, carried, close, t
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)


@pytest.mark.parametrize("length,channels", [(64, 32), (10, 7)])
def test_torch_fairseq_sinusoid_matches_jax(length, channels):
    np.testing.assert_allclose(fairseq_sinusoid_embedding(length, channels, 1),
                               np.asarray(jax_fairseq_sinusoid(length, channels, 1)),
                               atol=1e-6, rtol=0)


@pytest.fixture(scope="module", params=["concat", "add", "weighted_sum"])
def fused(request):
    return carried("seq2seq", seed=1, modality_fuse=request.param)


@pytest.mark.parametrize("presence", [(1, 1), (1, 0), (0, 1)], ids=["av", "a", "v"])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_torch_avhubert_encoder_fusion_matches_jax(fused, presence, padded):
    """``AVHuBERTEncoderWrapper`` (through the model's ``encode``): the
    streams times their [B] presence flags, fused, ``fuse_ln``,
    ``post_extract_proj``, the transformer with key lengths."""
    jmodel, variables, port, _ = fused
    audio, video, pad, _ = av_inputs(2)
    pad = pad if padded else None
    flags = [np.full((B,), f, np.float32) for f in presence]
    want = jmodel.apply(variables, audio=audio, video=video, padding_mask=pad,
                        audio_present=flags[0], video_present=flags[1], method=JaxS2T.encode)
    with torch.inference_mode():
        got = port.encode(audio=t(audio), video=t(video), padding_mask=t(pad),
                          audio_present=t(flags[0]), video_present=t(flags[1]))
    close(got, want)


@pytest.mark.parametrize("missing", ["audio", "video"])
def test_torch_avhubert_encoder_missing_stream_and_truncation(fused, missing):
    """A stream that is not given is zeros (``add`` passes the other one
    through); the streams are truncated to the shorter (video 5 frames
    against audio 7); feature and channel masks replace steps with
    ``mask_emb`` and zero channels."""
    jmodel, variables, port, pcfg = fused
    audio, video, pad, _ = av_inputs(3, t_video=5)
    kw = dict(audio=None if missing == "audio" else audio,
              video=None if missing == "video" else video, padding_mask=pad)
    rng = np.random.default_rng(4)
    fmask = rng.random((B, T)) < 0.3
    cmask = rng.random((B, pcfg.hidden_size)) < 0.2
    for extra in ({}, {"feature_mask": fmask, "channel_mask": cmask}):
        want = jmodel.apply(variables, **kw, **extra, method=JaxS2T.encode)
        with torch.inference_mode():
            got = port.encode(**{k: t(v) for k, v in {**kw, **extra}.items()})
        close(got, want, err_msg=str(sorted(extra)))
    both = jmodel.apply(variables, audio=audio, video=video, padding_mask=pad,
                        method=JaxS2T.encode)
    assert both.shape[1] == 5
    with torch.inference_mode():
        close(port.encode(audio=t(audio), video=t(video), padding_mask=t(pad)), both)
