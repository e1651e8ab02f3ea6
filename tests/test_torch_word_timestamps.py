"""Word timestamps of the port (decode/word_timestamps.py and the
transcriber's ``word_timestamps``) against the JAX package (CPU).

``dtw_path`` gives JAX's path on random costs and on integer costs full of
ties; ``_median_filter`` and ``attention_token_spans`` agree; the
cross-attention weights the port captures in a teacher-forced forward of
the tiny Whisper and Whisper-Flamingo models are within 1e-5 of those JAX
sows (``collect_cross_attention``, [B, L*H, Q, K]), and the word starts
and ends are equal; the transcriber with ``word_timestamps=True`` returns
JAX's words. The capture switches only the decoder's ``cross_attn`` and
is off again after the block, the logits unchanged.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.decode import word_timestamps as jax_wt
from avsl_tpu.kernels import log_mel_spectrogram as jax_log_mel
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode import word_timestamps as wt
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import (
    assert_same_results,
    carried_models,
    items,
    lip_feats,
    transcriber_pair,
)


@pytest.mark.parametrize("shape,integer", [((5, 12), False), ((9, 40), False), ((1, 7), False),
                                           ((6, 1), False), ((8, 30), True), ((12, 12), True)])
def test_torch_dtw_path_matches_jax(shape, integer):
    rng = np.random.default_rng(sum(shape))
    cost = rng.integers(0, 3, size=shape).astype(np.float64) if integer else rng.normal(size=shape)
    for c in (cost, cost.astype(np.float32)):
        want, got = jax_wt.dtw_path(c), wt.dtw_path(c)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("width", [1, 3, 7])
def test_torch_median_filter_and_spans_match_jax(width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(3, 9, 31))
    np.testing.assert_array_equal(wt._median_filter(x, width), jax_wt._median_filter(x, width))
    weights = rng.uniform(size=(4, 9, 40)).astype(np.float32)
    for n_frames in (40, 25, 9):
        assert wt.attention_token_spans(torch.from_numpy(weights), n_frames, width) == \
            jax_wt.attention_token_spans(weights, n_frames, width)


@pytest.fixture(scope="module", params=[False, True], ids=["audio_only", "av"])
def models(request):
    return request.param, carried_models(av=request.param, seed=31)


def _batch(av, seed=32):
    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    mel_audio = (0.2 * rng.standard_normal((2, 16000))).astype(np.float32)
    texts = [" hello world", " a bc"]
    rows = [tok.sot_sequence("en") + tok.encode(t) + [tok.eot] for t in texts]
    width = max(len(r) for r in rows)
    tokens = np.asarray([r + [tok.eot] * (width - len(r)) for r in rows], np.int64)
    video = rng.normal(size=(2, 25, 88, 88, 1)).astype(np.float32) if av else None
    return mel_audio, tokens, video


def test_torch_captured_weights_and_words_match_jax(models):
    av, (jmodel, variables, port) = models
    audio, tokens, video = _batch(av)
    jmel = jax_log_mel(jnp.asarray(audio), n_mels=jmodel.cfg.n_mels)
    kw = {} if video is None else {"video": jnp.asarray(video)}
    _, inter = jmodel.apply(variables, jmel, jnp.asarray(tokens, jnp.int32),
                            mutable=["alignment"], **kw)
    want = jax_wt.collect_cross_attention(inter["alignment"])
    mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=port.cfg.n_mels)
    v = None if video is None else torch.from_numpy(video)
    with torch.inference_mode():
        base = port(mel, torch.from_numpy(tokens), v)
        with wt.capture_cross_attention(port) as captured:
            logits = port(mel, torch.from_numpy(tokens), v)
        again = port(mel, torch.from_numpy(tokens), v)
    got = wt.collect_cross_attention(captured).numpy()
    cfg = port.cfg
    assert got.shape == want.shape == (2, cfg.n_text_layer * cfg.n_text_head, tokens.shape[1], 50)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    torch.testing.assert_close(logits, base, atol=1e-5, rtol=0)
    assert torch.equal(again, base)
    assert all(b.cross_attn.capture is None for b in port.decoder.blocks)
    if av:  # the gated video cross-attention is never captured
        assert all(b.x_attn.capture is None for b in port.decoder.blocks)
    n_frames = [50, 31]
    want_words = jax_wt.whisper_word_timestamps(jmodel, variables, jmel, tokens,
                                                JaxByteTokenizer(), n_frames=n_frames, **kw)
    got_words = wt.whisper_word_timestamps(port, mel, tokens, ByteTokenizer(),
                                           n_frames=n_frames, video=v)
    assert got_words == want_words
    assert [w["word"] for w in got_words[0]] == ["hello", "world"]
    assert all(w["end_s"] <= n_frames[1] / 50 for w in got_words[1])


def test_torch_transcriber_word_timestamps_match_jax(models):
    av, pair = models
    its = items(4, seed=33)
    if av:
        its[1]["lip_feats"] = lip_feats(20, seed=33)
    jtr, ptr = transcriber_pair(pair, word_timestamps=True)
    want, got = jtr.transcribe(its), ptr.transcribe(its)
    assert_same_results(want, got, words=True)
    assert any(g.words for g in got)  # not vacuous
    for it, g in zip(its, got):
        window = min(len(it["audio"]), ptr.audio_max_length) / 16000
        times = [(w["start_s"], w["end_s"]) for w in g.words]
        assert all(0.0 <= s <= e <= window + 0.02 for s, e in times)
        assert [s for s, _ in times] == sorted(s for s, _ in times)
    # the words ride along the plain results unchanged
    plain = transcriber_pair(pair)[1].transcribe(its)
    assert [(p.tokens, p.avg_logprob) for p in plain] == [(g.tokens, g.avg_logprob) for g in got]
