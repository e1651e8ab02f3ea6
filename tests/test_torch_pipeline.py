"""Port serving path against the JAX StreamingTranscriber (CPU, fp32).

Both transcribers run the "test" model with the same carried weights and
a vocab of ``ByteTokenizer().add_tokens(["<laugh>"])`` (the tiny preset's
256 ids hold neither SOT 257 nor EOT 256). Tokens and text must be
identical; avg_logprob agrees to 1e-4. The greedy loop and the EOT mask
are also held against their JAX versions directly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.decode import greedy as jax_greedy
from avsl_tpu.infer import StreamingTranscriber as JaxTranscriber
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.cli.transcribe import main as transcribe_main
from avsl_tpu_torch.data.audio_segments import write_wav
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode import greedy
from avsl_tpu_torch.infer import StreamingTranscriber
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax


def _items(n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"id": f"utt{i}", "audio": (0.2 * rng.standard_normal(int(rng.integers(6000, 20000))))
         .astype(np.float32)}
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def transcribers():
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    jmodel, jcfg = jax_build("test", vocab_size=vocab, add_gated_x_attn=0,
                             use_av_hubert_encoder=False, dtype="float32")
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), np.zeros((2, jcfg.n_mels, 100), np.float32),
        np.zeros((2, 4), np.int32))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params,
    )
    kw = dict(audio_max_length=16000, batch_size=2, max_new_tokens=8)
    jtr = JaxTranscriber(jmodel, {"params": params}, JaxByteTokenizer(), video_frames=25, **kw)
    port, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=0,
                                     use_av_hubert_encoder=False, dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(params, n_audio_ctx=jcfg.n_audio_ctx))
    return jtr, StreamingTranscriber(port, ByteTokenizer(), **kw)


def test_torch_transcriber_matches_jax(transcribers):
    jtr, ptr = transcribers
    items = _items(3)
    want, got = jtr.transcribe(items), ptr.transcribe(items)
    assert len(got) == len(want) == 3
    assert any(t != ByteTokenizer().eot for w in want for t in w.tokens)  # not vacuous
    for w, g in zip(want, got):
        assert g.id == w.id
        assert g.tokens == w.tokens
        assert g.text == w.text
        assert g.has_video is False
        assert abs(g.avg_logprob - w.avg_logprob) <= 1e-4


def test_torch_transcribe_batch_matches_transcribe(transcribers):
    _, ptr = transcribers
    items = _items(2, seed=5)
    assert ptr.transcribe_batch(items) == ptr.transcribe(items)


@pytest.mark.parametrize("option", [
    {"beam_size": 2}, {"quantize": "int8"}, {"kv_int8": True}, {"mesh": object()},
    {"temperature_fallback": (0.2,)}, {"word_timestamps": True},
    {"draft_model": object()}, {"boost_phrases": ["hello"]},
])
def test_torch_transcriber_refuses_later_slices(transcribers, option):
    _, ptr = transcribers
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        StreamingTranscriber(ptr.model, ptr.tokenizer, **option)


@pytest.mark.parametrize("key", ["lip_video", "video", "lip_feats"])
def test_torch_transcriber_refuses_video_items(transcribers, key):
    _, ptr = transcribers
    item = dict(_items(1)[0], **{key: "clip.mp4"})
    with pytest.raises(NotImplementedError, match="slice 3"):
        ptr.transcribe_batch([item])


def _table_step(table, xp):
    """step_fn over a fixed logits table [steps, B, V]: the cache is the
    step counter."""
    def step(tok, idx):
        logits = table[idx][:, None, :]
        return xp.broadcast_to(logits, (logits.shape[0], tok.shape[1], logits.shape[2])), idx + 1
    return step


@pytest.mark.parametrize("eot_steps", [(2, 5, 30), (1, 1, 1), (30, 30, 30)])
def test_torch_greedy_decode_scored_matches_jax(eot_steps):
    rng = np.random.default_rng(sum(eot_steps))
    steps, b, v, eot, max_new = 12, 3, 11, 7, 10
    table = rng.normal(size=(steps, b, v)).astype(np.float32)
    for row, s in enumerate(eot_steps):
        if s < steps:
            table[s, row, eot] = 20.0  # EOT wins at step s
    prompt = np.zeros((b, 4), np.int32)
    want_t, want_s = jax_greedy.greedy_decode_scored(
        _table_step(jnp.asarray(table), jnp), jnp.asarray(0), jnp.asarray(prompt), max_new, eot)
    got_t, got_s = greedy.greedy_decode_scored(
        _table_step(torch.from_numpy(table), torch), 0, torch.from_numpy(prompt).long(),
        max_new, eot)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    plain = greedy.greedy_decode(
        _table_step(torch.from_numpy(table), torch), 0, torch.from_numpy(prompt).long(),
        max_new, eot)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_mask_after_eot_matches_jax(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 6, size=(4, 9)).astype(np.int64)
    want = np.asarray(jax_greedy.mask_after_eot(jnp.asarray(toks), 3))
    np.testing.assert_array_equal(greedy.mask_after_eot(torch.from_numpy(toks), 3).numpy(), want)
    logits = rng.normal(size=(4, 9, 6)).astype(np.float32)
    want_tf = np.asarray(jax_greedy.teacher_forced_predictions(jnp.asarray(logits), 3))
    got_tf = greedy.teacher_forced_predictions(torch.from_numpy(logits), 3).numpy()
    np.testing.assert_array_equal(got_tf, want_tf)


def test_torch_transcribe_cli_on_cpu(tmp_path):
    rng = np.random.default_rng(3)
    for name in ("a", "b"):
        write_wav(os.path.join(tmp_path, f"{name}.wav"),
                  (0.2 * rng.standard_normal(16000)).astype(np.float32))
    out = transcribe_main(["--input", str(tmp_path), "--smoke", "--device", "cpu",
                           "--batch_size", "2", "--max_new_tokens", "4"])
    assert [r["id"] for r in out] == ["a", "b"]
    assert all(np.isfinite(r["avg_logprob"]) and r["has_video"] is False for r in out)


def test_torch_transcribe_cli_needs_cuda_unless_cpu(tmp_path):
    write_wav(os.path.join(tmp_path, "a.wav"), np.zeros(16000, np.float32))
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transcribe_main(["--input", str(tmp_path), "--smoke"])
