"""The port's transcriber with beam search, against the JAX transcriber
(CPU, fp32), and the transcriber serving a model left in training mode.

Beam sizes 2 and 4 on the tiny audio-only model and on the tiny
Whisper-Flamingo model (lip features, a short clip and an audio-only
item in one batch), on the same carried weights: tokens and text
identical, the length-normalised best-beam score to 1e-4. Then the tiny
Whisper-Flamingo model as ``build_whisper_flamingo("test", device="cpu")``
builds it (with the byte tokenizer's vocab; bf16, the tower's dropouts
and BatchNorm), served after ``model.train()``: the same tokens and scores as in eval mode, every
buffer (BatchNorm running statistics included) bit-identical, and the
model handed back in training mode.
"""

import jax
import numpy as np
import pytest
import torch

from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.infer import StreamingTranscriber as JaxTranscriber
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.infer import StreamingTranscriber
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from test_torch_flamingo_common import noisy_av_variables, one_torch_thread  # noqa: F401
from test_torch_pipeline import _items, _lip_feats

KW = dict(audio_max_length=16000, video_frames=25, batch_size=3, max_new_tokens=8)


def _models(av: bool):
    """JAX and port models of the tiny preset on the same weights."""
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    jmodel, jcfg = jax_build("test", vocab_size=vocab, add_gated_x_attn=int(av),
                             use_av_hubert_encoder=av, dtype="float32")
    init_kw = {"video": np.zeros((2, 5, 88, 88, 1), np.float32)} if av else {}
    variables = jax.jit(lambda k, m, t, **kw: jmodel.init(k, m, t, **kw))(
        jax.random.PRNGKey(3), np.zeros((2, jcfg.n_mels, 100), np.float32),
        np.zeros((2, 4), np.int32), **init_kw)
    rng = np.random.default_rng(4)
    if av:
        variables = noisy_av_variables(variables, rng)
    else:
        variables = {"params": jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
            variables["params"])}
    port, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=int(av),
                                     use_av_hubert_encoder=av, dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(
        variables["params"], n_audio_ctx=jcfg.n_audio_ctx,
        batch_stats=variables.get("batch_stats")))
    return jmodel, variables, port


@pytest.fixture(scope="module", params=[False, True], ids=["audio_only", "av"])
def models(request):
    return request.param, _models(request.param)


@pytest.mark.parametrize("beam_size", [2, 4])
def test_torch_beam_transcriber_matches_jax(models, beam_size):
    av, (jmodel, variables, port) = models
    items = _items(3, seed=20 + beam_size)
    if av:
        items[0]["lip_feats"] = _lip_feats(25, seed=5)
        items[1]["lip_feats"] = _lip_feats(9, seed=6)
    jtr = JaxTranscriber(jmodel, variables, JaxByteTokenizer(), beam_size=beam_size, **KW)
    ptr = StreamingTranscriber(port, ByteTokenizer(), beam_size=beam_size, **KW)
    want, got = jtr.transcribe(items), ptr.transcribe(items)
    assert [g.has_video for g in got] == [w.has_video for w in want] == [av, av, False]
    assert any(t != ByteTokenizer().eot for w in want for t in w.tokens)  # not vacuous
    for w, g in zip(want, got):
        assert g.tokens == w.tokens and g.text == w.text
        assert abs(g.avg_logprob - w.avg_logprob) <= 1e-4


def _buffers(model):
    return {name: b.detach().clone() for name, b in model.named_buffers()}


def test_torch_transcriber_serves_a_training_model_in_eval_mode():
    vocab = ByteTokenizer().add_tokens(["<laugh>"])  # the tiny preset's 256 ids lack SOT/EOT
    model, _ = build_whisper_flamingo("test", vocab_size=vocab, device="cpu")
    kw = dict(KW, batch_size=2)
    items = _items(2, seed=30)
    for i, item in enumerate(items):
        item["lip_feats"] = _lip_feats(20 + i, seed=31 + i)
    want = StreamingTranscriber(model.eval(), ByteTokenizer(), **kw).transcribe(items)
    before = _buffers(model)
    assert any("running_mean" in n for n in before)
    model.train()
    got = StreamingTranscriber(model, ByteTokenizer(), **kw).transcribe(items)
    assert model.training and all(m.training for m in model.modules())
    assert [(g.tokens, g.avg_logprob, g.has_video) for g in got] == \
        [(w.tokens, w.avg_logprob, w.has_video) for w in want]
    after = _buffers(model)
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[n], before[n]) for n in before)
