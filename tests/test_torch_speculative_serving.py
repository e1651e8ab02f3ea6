"""Speculative decoding through the port's serving surface on the CPU,
against the JAX package: the transcriber with a draft (an independent
audio-only draft and the target as its own draft) gives the JAX
transcriber's results and ``spec_stats()``; its refusals carry JAX's
messages; ``cli.transcribe --draft_model`` runs with a random draft under
``--smoke`` and with ``--draft_ckpt`` written by the port's
``save_checkpoint``, and refuses a mismatched checkpoint and a random
draft outside ``--smoke``; ``/stats`` carries the draft's acceptance and
``/healthz`` the quantization; and the AV-HuBERT seq2seq decoder decodes
speculatively token for token as greedy, and as JAX.
"""

import json
import re
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.decode.speculative import speculative_greedy_decode as jax_spec
from avsl_tpu.infer import StreamingTranscriber as JaxTranscriber
from avsl_tpu.models.avhubert import AVHuBERTForSpeech2Text as JaxS2T
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.cli import transcribe
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode.greedy import greedy_decode
from avsl_tpu_torch.decode.speculative import speculative_greedy_decode
from avsl_tpu_torch.infer import StreamingTranscriber, TranscriptionServer
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from avsl_tpu_torch.train.checkpoints import save_checkpoint
from avsl_tpu_torch.train.loop import TrainState
from test_torch_avhubert_models import av_inputs, carried, t
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import KW, assert_same_results, carried_models, items

SPEC_K = 3


@pytest.fixture(scope="module")
def models():
    """(jax target, variables, port target) on the tiny Whisper-Flamingo
    model, and (jax draft, variables, port draft): the tiny preset,
    audio-only, its own noisy weights."""
    target = carried_models(av=True, seed=21, logit_scale=4.0)
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    jdraft, dcfg = jax_build("test", vocab_size=vocab, add_gated_x_attn=0,
                             use_av_hubert_encoder=False, dtype="float32")
    dvars = jax.jit(jdraft.init)(jax.random.PRNGKey(22), np.zeros((2, 80, 100), np.float32),
                                 np.zeros((2, 4), np.int32))
    rng = np.random.default_rng(23)
    dvars = {"params": jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        dvars["params"])}
    pdraft, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=0,
                                       use_av_hubert_encoder=False, dtype="float32",
                                       device="cpu")
    pdraft.load_state_dict(whisper_state_dict_from_flax(dvars["params"],
                                                        n_audio_ctx=dcfg.n_audio_ctx))
    return target, (jdraft, dvars, pdraft.eval())


def _pair(models, self_draft: bool, **kw):
    (jmodel, variables, port), (jdraft, dvars, pdraft) = models
    kw = {**KW, "batch_size": 2, "max_new_tokens": 8, "spec_k": SPEC_K, **kw}
    jd, jv, pd = (jmodel, variables, port) if self_draft else (jdraft, dvars, pdraft)
    return (JaxTranscriber(jmodel, variables, JaxByteTokenizer(), draft_model=jd,
                           draft_variables=jv, **kw),
            StreamingTranscriber(port, ByteTokenizer(), draft_model=pd, **kw))


@pytest.mark.parametrize("self_draft", [False, True])
def test_torch_transcriber_with_draft_matches_jax(models, self_draft):
    jtr, ptr = _pair(models, self_draft)
    batch = items(3, seed=5)
    batch[2]["lip_feats"] = np.random.default_rng(1).normal(size=(25, 88, 88, 1)).astype(
        np.float32)
    assert_same_results(jtr.transcribe(batch), ptr.transcribe(batch))
    want, got = jtr.spec_stats(), ptr.spec_stats()
    assert got["batches"] == want["batches"] == 2
    assert got["mean_verify_rounds"] == want["mean_verify_rounds"]
    assert got["mean_accept_rate"] == pytest.approx(want["mean_accept_rate"], abs=1e-7)
    # plain greedy serving gives the same results and no speculative stats
    plain = StreamingTranscriber(models[0][2], ByteTokenizer(),
                                 **{**KW, "batch_size": 2, "max_new_tokens": 8})
    assert_same_results(plain.transcribe(batch), ptr.transcribe(batch), logprob_atol=1e-5)
    assert plain.spec_stats() is None


@pytest.mark.parametrize("option", [
    {"beam_size": 2}, {"spec_k": 0}, {"boost_phrases": ["abc"]}, {"draft_variables": None},
    {"quantize": "int4"},
])
def test_torch_transcriber_refusals_carry_jax_messages(models, option):
    (jmodel, variables, port), (jdraft, dvars, pdraft) = models
    jkw = {"draft_model": jdraft, "draft_variables": dvars, **option}
    pkw = {"draft_model": pdraft, **option}
    if "draft_variables" in option:  # a draft without its weights
        pkw = {"draft_model": torch.nn.Module.to(build_whisper_flamingo(
            "test", add_gated_x_attn=0, dtype="float32", device="cpu")[0], "meta")}
    with pytest.raises(ValueError) as want:
        JaxTranscriber(jmodel, variables, JaxByteTokenizer(), **jkw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        StreamingTranscriber(port, ByteTokenizer(), **pkw)


def _wavs(tmp_path, n=2):
    d = tmp_path / "segs"
    d.mkdir()
    for i in range(n):
        x = 0.2 * np.sin(2 * np.pi * (200 + 80 * i) * np.arange(16000) / 16000)
        wavfile.write(str(d / f"seg{i}.wav"), 16000, (x * 32767).astype(np.int16))
    return str(d)


def _cli(wavs, *flags):
    return transcribe.main(["--input", wavs, "--device", "cpu", "--batch_size", "2",
                            "--max_new_tokens", "6", *flags])


def test_torch_transcribe_cli_with_draft(tmp_path):
    """``--draft_model test --smoke``, then the draft's checkpoint written by
    ``save_checkpoint`` and read back through ``--draft_ckpt``: the same
    results as the CLI without a draft."""
    wavs = _wavs(tmp_path)
    plain = _cli(wavs, "--smoke")
    random_draft = _cli(wavs, "--smoke", "--draft_model", "test", "--spec_k", "3",
                        "--output", str(tmp_path / "out.json"))
    assert [r["text"] for r in random_draft] == [r["text"] for r in plain]
    assert json.load(open(tmp_path / "out.json")) == random_draft
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    draft, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=0,
                                      dtype="float32", device="cpu", seed=4)
    save_checkpoint(str(tmp_path / "draft"), TrainState.create(draft, None), 1)
    restored = _cli(wavs, "--smoke", "--draft_model", "test",
                    "--draft_ckpt", str(tmp_path / "draft"))
    assert [(r["text"], r["avg_logprob"]) for r in restored] == [
        (r["text"], r["avg_logprob"]) for r in plain]


def test_torch_transcribe_cli_takes_int8_weights_and_cache(tmp_path):
    wavs = _wavs(tmp_path)
    out = _cli(wavs, "--smoke", "--quantize", "int8", "--kv_int8")
    assert [r["id"] for r in out] == ["seg0", "seg1"]
    assert all(np.isfinite(r["avg_logprob"]) for r in out)


def test_torch_transcribe_cli_draft_refusals(tmp_path):
    wavs = _wavs(tmp_path, 1)
    other, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32", device="cpu")
    save_checkpoint(str(tmp_path / "av"), TrainState.create(other, None), 1)
    with pytest.raises(SystemExit, match="does not match --draft_model 'test'"):
        _cli(wavs, "--smoke", "--draft_model", "test", "--draft_ckpt", str(tmp_path / "av"))
    with pytest.raises(SystemExit, match="no checkpoint under"):
        _cli(wavs, "--smoke", "--draft_model", "test", "--draft_ckpt", str(tmp_path / "none"))
    # before any model is built: a random draft outside --smoke, a beam, spec_k < 1
    with pytest.raises(SystemExit, match="needs --draft_ckpt"):
        _cli(wavs, "--draft_model", "tiny")
    with pytest.raises(SystemExit, match="greedy only"):
        _cli(wavs, "--smoke", "--draft_model", "test", "--beam", "2")
    with pytest.raises(SystemExit, match="spec_k must be >= 1"):
        _cli(wavs, "--smoke", "--draft_model", "test", "--spec_k", "0")
    with pytest.raises(SystemExit, match="needs float weights"):
        _cli(wavs, "--smoke", "--detect_language", "--quantize", "int8")


def _get(srv, path):
    host, port = srv.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_torch_server_reports_speculative_stats_and_quantize(models):
    _, ptr = _pair(models, self_draft=False, quantize="int8")
    srv = TranscriptionServer(ptr, port=0, max_wait_ms=10.0).start()
    try:
        assert "speculative" not in _get(srv, "/stats")
        assert _get(srv, "/healthz")["quantize"] == "int8"
        assert srv.submit({"id": "a", "audio": items(1, seed=3)[0]["audio"]}).done.wait(120)
        stats = _get(srv, "/stats")
    finally:
        srv.stop()
    assert stats["speculative"] == ptr.spec_stats() and stats["speculative"]["batches"] == 1
    plain = TranscriptionServer(StreamingTranscriber(models[0][2], ByteTokenizer(), **KW),
                                port=0).start()
    try:
        assert _get(plain, "/healthz")["quantize"] is None
    finally:
        plain.stop()


def test_torch_spec_exact_on_avhubert_seq2seq():
    """The AV-HuBERT seq2seq decoder (its fairseq positions, the masked
    cross-attention) through the same vector-index cache: token-exact
    against greedy with an independent and a self draft, as JAX."""
    jt, vt, pt, cfg = carried("seq2seq", seed=0)
    jd, vd, pd, _ = carried("seq2seq", seed=11)
    audio, video, pad, _ = av_inputs(3)
    max_new, k = 10, 3
    prompt = np.asarray([[cfg.eos_token_id, 5], [cfg.eos_token_id, 7], [cfg.eos_token_id, 9]])
    need = prompt.shape[1] + max_new + k
    eot = cfg.eos_token_id

    def jside(m, v):
        enc = jax.jit(lambda v: m.apply(v, audio=audio, video=video, padding_mask=pad,
                                        method=JaxS2T.encode))(v)
        step = jax.jit(lambda tok, c: m.apply(v, tok, enc, pad, c, method=JaxS2T.decode))
        return step, jax.jit(lambda: m.apply(v, enc, need, method=JaxS2T.init_decode_cache))

    def pside(m):
        enc = m.encode(audio=t(audio), video=t(video), padding_mask=t(pad))
        return (lambda tok, c: m.decode(tok, enc, t(pad), c),
                lambda: m.init_decode_cache(enc, need))

    (js, jc), (jds, jdc) = jside(jt, vt), jside(jd, vd)
    jp = jnp.asarray(prompt, jnp.int32)
    with torch.inference_mode():
        (ps, pc), (pds, pdc) = pside(pt), pside(pd)
        ref = greedy_decode(ps, pc(), t(prompt), max_new, eot)
        for draft in ("other", "self"):
            dstep, dcache = (pds, pdc) if draft == "other" else (ps, pc)
            got = speculative_greedy_decode(ps, dstep, pc(), dcache(), t(prompt), max_new, eot,
                                            k=k)
            jdstep, jdcache = (jds, jdc) if draft == "other" else (js, jc)
            want = jax.jit(lambda tc, dc: jax_spec(js, jdstep, tc, dc, jp, max_new, eot, k=k))(
                jc(), jdcache())
            np.testing.assert_array_equal(got.tokens.numpy(), ref.numpy())
            np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
            assert float(got.accept_rate) == float(want.accept_rate)
            assert got.rounds == int(want.rounds)
        assert float(got.accept_rate) > 0.8  # the self draft
