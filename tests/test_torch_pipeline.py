"""Port serving path against the JAX StreamingTranscriber (CPU, fp32).

Both transcribers run the "test" model with the same carried weights and
a vocab of ``ByteTokenizer().add_tokens(["<laugh>"])`` (the tiny preset's
256 ids hold neither SOT 257 nor EOT 256). Tokens and text must be
identical; avg_logprob agrees to 1e-4. This holds for the audio-only
model and for the Whisper-Flamingo one (the tiny AV-HuBERT tower, gated
cross-attention with nonzero gates, BatchNorm statistics perturbed) on a
batch that mixes lip features, a lip clip mp4, a short clip and an
audio-only item, and on raw closeup mp4s lip-cropped in both
``raw_lip_mode``s. The greedy loop and the EOT mask are also held against
their JAX versions directly.
"""

import copy
import os
from types import SimpleNamespace

import cv2
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
from avsl_tpu_torch.data.video_io import read_video_frames, write_video_frames
from avsl_tpu_torch.decode import greedy
from avsl_tpu_torch.infer import StreamingTranscriber
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from torch_lip_fixtures import assert_crops_match, closeup_clips, face_clip

# the lip frames the two transcribers feed their models from a raw closeup:
# the device frontend's crops within 0.5 grey levels (tests/
# test_torch_lip_pipeline.py), normalised by 255 * 0.165; the host-refined
# crops within 1 grey level (uint8 truncation), a frame a pixel over only
# on the reference's crop-window knife edge
DEVICE_LIP_ATOL = 0.5 / (255 * 0.165)
REFINED_LIP_ATOL = 1.0
# the mean token log-probability then differs by what those lip-frame
# differences move the tiny model (measured up to 2.8e-3 on the closeups)
RAW_LOGPROB_ATOL = 1e-2


def _write_lip_mp4(path, n_frames, seed=0, size=96):
    """A grayscale lip clip of ``n_frames`` noise frames at 25 fps."""
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (size, size),
                             isColor=False)
    assert writer.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        writer.write(rng.integers(0, 256, (size, size), dtype=np.uint8))
    writer.release()
    return str(path)


def _lip_feats(n_frames, seed=0, crop=88):
    """Normalised lip features [T, crop, crop, 1], as load_video_feats gives."""
    rng = np.random.default_rng(seed)
    return ((rng.uniform(size=(n_frames, crop, crop, 1)) - 0.421) / 0.165).astype(np.float32)


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


# what the transcriber refuses: the JAX transcriber's refusals of the
# serving options, with its messages (a draft on the meta device is a draft
# without weights; "dp2" and "mp2" name a mesh of 2 data or 2 model ranks,
# refused before it is used)
REFUSALS = [
    ({"draft_variables": {}}, ValueError, "go together"),
    ({"quantize": "int4"}, ValueError, "expected None or 'int8'"),
    ({"quantize": "int8", "mesh": "mp2"}, ValueError, r"quantize \+ mesh unsupported"),
    ({"batch_size": 3, "mesh": "dp2"}, ValueError, "not divisible by the mesh data axis"),
    ({"draft_model": "meta"}, ValueError, "go together"),
    ({"draft_model": "cpu", "beam_size": 2}, ValueError, "greedy only"),
    ({"draft_model": "cpu", "spec_k": 0}, ValueError, "spec_k must be >= 1"),
    ({"draft_model": "cpu", "boost_phrases": ["ab"]}, ValueError, "does not compose"),
]


@pytest.mark.parametrize("option", [r[0] for r in REFUSALS])
def test_torch_transcriber_refuses_later_slices(transcribers, option):
    _, ptr = transcribers
    _, error, match = next(r for r in REFUSALS if r[0] is option)
    kw = dict(option)
    if "mesh" in kw:
        kw["mesh"] = SimpleNamespace(shape={"data": 2 if kw["mesh"] == "dp2" else 1,
                                            "model": 2 if kw["mesh"] == "mp2" else 1})
    if "draft_model" in kw:
        kw["draft_model"] = ptr.model if kw["draft_model"] == "cpu" else copy.deepcopy(
            ptr.model).to("meta")
    with pytest.raises(error, match=match):
        StreamingTranscriber(ptr.model, ptr.tokenizer, **kw)


def _capture_video(monkeypatch, obj, name):
    """Record the video batch ``obj.name(audio, video)`` feeds the model."""
    seen = []
    inner = getattr(obj, name)

    def wrapped(audio, video, *args, **kw):
        v = video.detach().cpu().numpy() if isinstance(video, torch.Tensor) else np.asarray(video)
        seen.append(v)
        return inner(audio, video, *args, **kw)

    monkeypatch.setattr(obj, name, wrapped)
    return seen


def _raw_closeups(tmp_path):
    """Two raw closeup mp4s: a rendered talking face at the transcribers'
    raw size (144 x 176) and a moving textured head at 160 x 200 (resized
    on load)."""
    face = write_video_frames(str(tmp_path / "face-video.mp4"), face_clip(t=30)[0])
    head = write_video_frames(str(tmp_path / "head-video.mp4"),
                              closeup_clips(b=1, t=30, h=160, w=200, seed=3)[0])
    return face, head


def _refined_lms(path, frames_max):
    """The JAX host_refined landmarks of a closeup (to place the knife edge)."""
    from avsl_tpu.data.lip_refine import RefinedMouthTracker
    from avsl_tpu.data.lip_roi import landmarks_interpolate, smooth_landmarks

    frames = read_video_frames(path, grayscale=True, max_frames=frames_max)
    return smooth_landmarks(landmarks_interpolate(RefinedMouthTracker()(frames)), 12)


def _assert_same_results(want, got, logprob_atol=1e-4):
    """Served with has_video set, the same tokens and text as the JAX
    transcriber, avg_logprob within ``logprob_atol``."""
    assert [g.has_video for g in got] == [w.has_video for w in want] == [True] * len(want)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens and g.text == w.text
        assert abs(g.avg_logprob - w.avg_logprob) <= logprob_atol


@pytest.mark.parametrize("key", ["lip_video", "video", "lip_feats"])
def test_torch_transcriber_refuses_video_items(transcribers, av_transcribers, key, tmp_path,
                                               monkeypatch):
    """Video items. Lip features, a lip clip and raw 'video' closeups
    (alone or behind a lip clip that fails to load) are served with
    has_video set, exactly as the JAX transcriber serves them: by the
    audio-only model, which ignores the video, with equal tokens, text and
    avg_logprob within 1e-4; lip features and the lip clip by the tiny AV
    model within 1e-4 too. The AV model lip-crops the raw closeups in both
    raw_lip_modes: the tokens equal the JAX transcriber's, the lip frames
    fed to the model agree (DEVICE_LIP_ATOL, REFINED_LIP_ATOL) and so do
    the scores (RAW_LOGPROB_ATOL)."""
    ajtr, aptr = transcribers
    jtr, ptr = av_transcribers
    base = _items(1, seed=11)[0]
    broken = tmp_path / "broken-lip.mp4"
    broken.write_bytes(b"not a video")
    lip_items = []
    if key == "lip_feats":
        lip_items = [dict(base, lip_feats=_lip_feats(12))]
    elif key == "lip_video":
        corrupt_only = dict(base, lip_video=str(broken))  # falls through to audio-only
        for tr in (aptr, ajtr, ptr, jtr):
            assert tr.transcribe_batch([corrupt_only])[0].has_video is False
        lip_items = [dict(base, lip_video=_write_lip_mp4(tmp_path / "lip.mp4", 12))]
    for item in lip_items:
        _assert_same_results(ajtr.transcribe_batch([item]), aptr.transcribe_batch([item]))
        _assert_same_results(jtr.transcribe_batch([item]), ptr.transcribe_batch([item]))
    if key == "lip_feats":
        return
    face, head = _raw_closeups(tmp_path)
    extra = {"lip_video": str(broken)} if key == "lip_video" else {}
    items = [dict(base, id="face", video=face, **extra), dict(_items(2, seed=12)[1], id="head",
                                                             video=head, **extra)]
    _assert_same_results(ajtr.transcribe_batch(items), aptr.transcribe_batch(items))
    for mode in ("host_refined", "device"):
        jt = copy.copy(jtr)
        jt.raw_lip_mode = mode
        pt = StreamingTranscriber(ptr.model, ptr.tokenizer, raw_lip_mode=mode, **ptr_kw(ptr))
        seen_j = _capture_video(monkeypatch, jt, "_dispatch")
        seen_p = _capture_video(monkeypatch, pt, "_run")
        _assert_same_results(jt.transcribe_batch(items), pt.transcribe_batch(items),
                             RAW_LOGPROB_ATOL)
        vj, vp = seen_j[-1], seen_p[-1]
        assert vp.shape == vj.shape == (2, 25, 88, 88, 1)
        assert np.abs(vj).max() > 0.5  # the closeups reached the model
        if mode == "device":
            np.testing.assert_allclose(vp, vj, rtol=0, atol=DEVICE_LIP_ATOL)
        else:  # back to grey levels, compared frame by frame
            for row, path in enumerate((face, head)):
                lms = _refined_lms(path, 25)
                to_grey = lambda v: (v[row, ..., 0] * 0.165 + 0.421) * 255.0  # noqa: E731
                assert_crops_match(to_grey(vp), to_grey(vj), lms, REFINED_LIP_ATOL)


def ptr_kw(ptr):
    """The serving shape a port transcriber was built with."""
    return dict(audio_max_length=ptr.audio_max_length, video_frames=ptr.video_frames,
                batch_size=ptr.batch_size, max_new_tokens=ptr.max_new_tokens,
                raw_video_hw=ptr.raw_video_hw)


def _noisy_av_variables(variables, rng):
    """Noise on every param, BatchNorm means shifted and variances 1 +
    |noise|, and every gate set to 0.7 (x_attn) or -0.5 (x_mlp)."""
    def param(path, x):
        name = str(path[-1].key)
        if name in ("x_attn_gate", "x_mlp_gate"):
            return np.full(np.shape(x), 0.7 if name == "x_attn_gate" else -0.5, np.float32)
        return np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)

    def stat(path, x):
        noise = rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.asarray(x) + (np.abs(0.5 * noise) if path[-1].key == "var" else 0.2 * noise)

    return {"params": jax.tree_util.tree_map_with_path(param, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


@pytest.fixture(scope="module")
def av_transcribers():
    """JAX and port transcribers of the tiny Flamingo model on the same
    weights, at the JAX CLI's smoke serving shape (1 s windows, 25 video
    frames of 88 x 88, batch 2)."""
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    jmodel, jcfg = jax_build("test", vocab_size=vocab, add_gated_x_attn=1,
                             use_av_hubert_encoder=True, dtype="float32")
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), np.zeros((2, jcfg.n_mels, 100), np.float32),
        np.zeros((2, 4), np.int32), video=np.zeros((2, 5, 88, 88, 1), np.float32))
    variables = _noisy_av_variables(variables, np.random.default_rng(2))
    kw = dict(audio_max_length=16000, video_frames=25, batch_size=2, max_new_tokens=8,
              raw_video_hw=(144, 176))
    jtr = JaxTranscriber(jmodel, variables, JaxByteTokenizer(), **kw)
    port, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=1,
                                     use_av_hubert_encoder=True, dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(
        variables["params"], n_audio_ctx=jcfg.n_audio_ctx, batch_stats=variables["batch_stats"]))
    return jtr, StreamingTranscriber(port, ByteTokenizer(), **kw)


@pytest.fixture(scope="module")
def av_items(tmp_path_factory):
    """lip features (25 frames), a lip clip mp4 (20 frames), a short clip
    (9 frames of features) and an audio-only item."""
    items = _items(4, seed=7)
    clip = _write_lip_mp4(tmp_path_factory.mktemp("av") / "seg1-lip.mp4", 20, seed=3)
    items[0]["lip_feats"] = _lip_feats(25, seed=1)
    items[1]["lip_video"] = clip
    items[2]["lip_feats"] = _lip_feats(9, seed=2)
    return items


def test_torch_av_transcriber_matches_jax(av_transcribers, av_items):
    jtr, ptr = av_transcribers
    want, got = jtr.transcribe(av_items), ptr.transcribe(av_items)
    assert [g.has_video for g in got] == [w.has_video for w in want] == [True, True, True, False]
    assert any(t != ByteTokenizer().eot for w in want for t in w.tokens)  # not vacuous
    for w, g in zip(want, got):
        assert g.id == w.id
        assert g.tokens == w.tokens
        assert g.text == w.text
        assert abs(g.avg_logprob - w.avg_logprob) <= 1e-4


def test_torch_av_transcriber_video_moves_the_result(av_transcribers, av_items):
    """Not vacuous: the same items with zeroed lip features score
    differently."""
    _, ptr = av_transcribers
    zeroed = [dict(av_items[0], lip_feats=np.zeros_like(av_items[0]["lip_feats"])), av_items[3]]
    got = ptr.transcribe_batch([av_items[0], av_items[3]])
    other = ptr.transcribe_batch(zeroed)
    assert got[1] == other[1]  # the audio-only row does not see the other row's video
    assert got[0].avg_logprob != other[0].avg_logprob or got[0].tokens != other[0].tokens


def test_torch_av_transcribe_batch_matches_transcribe(av_transcribers, av_items):
    _, ptr = av_transcribers
    assert ptr.transcribe_batch(av_items[:2]) == ptr.transcribe(av_items[:2])


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


def test_torch_transcribe_cli_defaults_to_flamingo(tmp_path):
    """Without --config the CLI serves the JAX CLI's default,
    FlamingoTrainConfig(): the AV model, here its tiny --smoke version at
    the 1 s window and its 25 video frames; a <stem>-lip.mp4 is its lip
    clip, a <stem>-video.mp4 a raw closeup, lip-cropped on the host."""
    rng = np.random.default_rng(4)
    for name in ("a", "b"):
        write_wav(os.path.join(tmp_path, f"{name}.wav"),
                  (0.2 * rng.standard_normal(16000)).astype(np.float32))
    _write_lip_mp4(tmp_path / "b-lip.mp4", 30)
    out = transcribe_main(["--input", str(tmp_path), "--smoke", "--device", "cpu",
                           "--batch_size", "2", "--max_new_tokens", "4"])
    assert [(r["id"], r["has_video"]) for r in out] == [("a", False), ("b", True)]
    write_video_frames(str(tmp_path / "a-video.mp4"), face_clip(t=30)[0])
    out = transcribe_main(["--input", str(tmp_path), "--smoke", "--device", "cpu",
                           "--batch_size", "2", "--max_new_tokens", "4"])
    assert [(r["id"], r["has_video"]) for r in out] == [("a", True), ("b", True)]
    assert all(np.isfinite(r["avg_logprob"]) for r in out)


def test_torch_serving_video_frames():
    """The audio window at 25 fps, at most 250 frames (the JAX CLI's rule)."""
    from avsl_tpu_torch.cli._serving_common import serving_video_frames

    assert [serving_video_frames(n) for n in (16000, 100000, 160000, 480000)] == [25, 156, 250, 250]


def test_torch_transcribe_cli_needs_cuda_unless_cpu(tmp_path):
    write_wav(os.path.join(tmp_path, "a.wav"), np.zeros(16000, np.float32))
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transcribe_main(["--input", str(tmp_path), "--smoke"])
