"""Shared inputs of the serving-daemon parity tests: the tiny Whisper and
Whisper-Flamingo models on carried weights in both packages, their
transcribers, JAX's Gumbel noise for the port's sampled decode, and
seeded speech-like PCM.

The port draws sampling noise through ``avsl_tpu_torch.decode.greedy.
gumbel_noise(generator, shape, device)``, one ``[B, V]`` draw a step.
:func:`patch_jax_noise` replaces it with the draws JAX's
``sampled_decode_scored`` makes: ``k0, rng = split(key)`` for the first
step, then ``split(rng, max_new_tokens - 1)[i - 1]`` for step i, where
``key`` is ``fold_in(PRNGKey(1234), seed - 1234)`` for a generator seeded
``seed`` (the transcriber's fallback seeds ``1234 + 31 n + k`` where JAX
folds ``31 n + k`` in), or a key given outright.
"""

import numpy as np
import torch

import jax

from avsl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from avsl_tpu.infer import StreamingTranscriber as JaxTranscriber
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode import greedy as port_greedy
from avsl_tpu_torch.infer import StreamingTranscriber
from avsl_tpu_torch.models import build_whisper_flamingo, whisper_state_dict_from_flax
from test_torch_flamingo_common import noisy_av_variables

SR = 16000
# the JAX CLI's smoke serving shape: 1 s windows, 25 video frames
KW = dict(audio_max_length=16000, video_frames=25, batch_size=3, max_new_tokens=8)


def carried_models(av: bool, seed: int = 3, logit_scale: float = 1.0):
    """(jax model, jax variables, port model): the tiny preset (with the
    tiny AV-HuBERT tower and nonzero gates when ``av``) on the same noisy
    weights, fp32, the port's on the CPU. ``logit_scale`` multiplies the
    decoder's final layer norm, and so its logits: the noisy tiny model's
    next-token distributions are nearly flat, a trained model's sharp."""
    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    jmodel, jcfg = jax_build("test", vocab_size=vocab, add_gated_x_attn=int(av),
                             use_av_hubert_encoder=av, dtype="float32")
    init_kw = {"video": np.zeros((2, 5, 88, 88, 1), np.float32)} if av else {}
    variables = jax.jit(lambda k, m, t, **kw: jmodel.init(k, m, t, **kw))(
        jax.random.PRNGKey(seed), np.zeros((2, jcfg.n_mels, 100), np.float32),
        np.zeros((2, 4), np.int32), **init_kw)
    rng = np.random.default_rng(seed + 1)
    if av:
        variables = noisy_av_variables(variables, rng)
    else:
        variables = {"params": jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
            variables["params"])}
    ln = variables["params"]["decoder"]["ln"]["LayerNorm_0"]
    for name in ("scale", "bias"):
        ln[name] = np.asarray(ln[name]) * np.float32(logit_scale)
    port, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=int(av),
                                     use_av_hubert_encoder=av, dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(
        variables["params"], n_audio_ctx=jcfg.n_audio_ctx,
        batch_stats=variables.get("batch_stats")))
    return jmodel, variables, port.eval()


def transcriber_pair(models, **kw):
    """JAX and port transcribers over ``carried_models``' output, at ``KW``
    overridden by ``kw``."""
    jmodel, variables, port = models
    kw = {**KW, **kw}
    return (JaxTranscriber(jmodel, variables, JaxByteTokenizer(), **kw),
            StreamingTranscriber(port, ByteTokenizer(), **kw))


def items(n: int, seed: int = 0, lo: int = 6000, hi: int = 20000):
    """``n`` items of seeded noise PCM, ``lo`` to ``hi`` samples each."""
    rng = np.random.default_rng(seed)
    return [{"id": f"utt{i}",
             "audio": (0.2 * rng.standard_normal(int(rng.integers(lo, hi)))).astype(np.float32)}
            for i in range(n)]


def lip_feats(n_frames: int, seed: int = 0, crop: int = 88):
    rng = np.random.default_rng(seed)
    return ((rng.uniform(size=(n_frames, crop, crop, 1)) - 0.421) / 0.165).astype(np.float32)


def speech_with_pauses(n_bursts: int = 4, burst_s: float = 1.0, pause_s: float = 0.5, seed=0):
    """Tone bursts separated by near-silence; returns (audio, pause spans in
    samples)."""
    rng = np.random.default_rng(seed)
    parts, pauses, pos = [], [], 0
    for i in range(n_bursts):
        burst = 0.3 * np.sin(2 * np.pi * (220 + 60 * i) * np.arange(int(SR * burst_s)) / SR)
        burst = burst + 0.05 * rng.standard_normal(len(burst))
        parts.append(burst)
        pos += len(burst)
        quiet = 0.001 * rng.standard_normal(int(SR * pause_s))
        pauses.append((pos, pos + len(quiet)))
        parts.append(quiet)
        pos += len(quiet)
    return np.concatenate(parts).astype(np.float32), pauses


def jax_gumbel_draws(key, max_new_tokens: int, shape):
    """The Gumbel draws JAX's ``sampled_decode_scored`` makes from ``key``,
    in step order."""
    k0, rng = jax.random.split(key)
    keys = [k0, *jax.random.split(rng, max(max_new_tokens - 1, 1))]
    return [np.array(jax.random.gumbel(k, shape, np.float32)) for k in keys]


def patch_jax_noise(monkeypatch, max_new_tokens: int, key=None):
    """Make the port's sampled decode draw JAX's noise: from ``key``, or per
    generator from ``fold_in(PRNGKey(1234), seed - 1234)``. Returns the
    list of generator seeds seen, in order of first use."""
    seen, streams = [], {}

    def fake(generator, shape, device):
        seed = generator.initial_seed()
        if seed not in streams:
            seen.append(seed)
            k = key if key is not None else jax.random.fold_in(jax.random.PRNGKey(1234),
                                                               seed - 1234)
            streams[seed] = iter(jax_gumbel_draws(k, max_new_tokens, shape))
        return torch.from_numpy(next(streams[seed])).to(device)

    monkeypatch.setattr(port_greedy, "gumbel_noise", fake)
    return seen


def assert_same_results(want, got, logprob_atol=1e-4, words=False):
    """Equal ids, tokens, text and video flags; avg_logprob within
    ``logprob_atol``; with ``words`` equal word lists."""
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert (g.id, g.tokens, g.text, g.has_video) == (w.id, w.tokens, w.text, w.has_video)
        assert abs(g.avg_logprob - w.avg_logprob) <= logprob_atol
        if words:
            assert g.words == w.words


def strict_bf16(jtr):
    """Compile the JAX transcriber's program without XLA's excess
    precision, so that it rounds where it says it does. Inside a jitted
    program XLA may keep a value it was told to round to bf16 in fp32 (it
    does so on the CPU for the int8 weights' ``dequantize`` to bf16, and
    its avg_logprob then differs from the eager port's by up to 1.3e-3);
    with this flag off the two agree exactly."""
    args = (np.zeros((jtr.batch_size, jtr.audio_max_length), np.float32),
            np.zeros((jtr.batch_size, jtr.video_frames, jtr.crop, jtr.crop, 1), np.float32),
            jtr._prompt)
    jtr._run = jtr._run.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return jtr

