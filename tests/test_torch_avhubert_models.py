"""AV-HuBERT seq2seq model of the port against the JAX package on carried
weights (CPU, fp32), and the carriers the other AV-HuBERT model tests use.

The JAX tiny models (``AVHuBERTConfig.tiny_test``, every training rate 0)
are initialised, every param gets seeded noise and every BatchNorm
statistic is perturbed; the same numbers go to the port through
``avhubert_state_dict_from_flax``. Outputs agree to atol 1e-5 + rtol 1e-4:
fp32 on both sides, summed in other orders. Here: the seq2seq model's
logits and loss with padded frames and padded decoder tokens (causal
self-attention with key lengths) as the large card builds it, with
learned positions and an untied projection, and post-norm with a decoder
wider than the encoder; its KV-cached
decode steps against full decoding; and the state dict in both
directions through the JAX package's fairseq converter. The fusion
encoder is in ``test_torch_avhubert_encoder.py``, the CTC head in
``test_torch_avhubert_ctc.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.avhubert import AVHuBERTForCTC as JaxCTC
from avsl_tpu.models.avhubert import AVHuBERTForSpeech2Text as JaxS2T
from avsl_tpu.models.convert import convert_avhubert_state_dict
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import avhubert_state_dict_from_flax, build_avhubert
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

TOL = dict(atol=1e-5, rtol=1e-4)
# every training draw off: the tower's and the decoder's dropouts, LayerDrop
# and modality dropout
ZERO_RATES = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  dropout_input=0.0, layerdrop=0.0, modality_dropout=0.0, decoder_dropout=0.0,
                  decoder_activation_dropout=0.0, decoder_layerdrop=0.0)
B, T, HW = 3, 7, 48


def perturb(variables, rng):
    """Noise on every param; BatchNorm means shifted, variances 1 + |noise|."""
    def stat(path, x):
        noise = rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.asarray(x) + (np.abs(0.5 * noise) if path[-1].key == "var" else 0.2 * noise)

    out = {"params": jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    return out


def configs(**overrides):
    """(JAX config, port config): tiny, fp32, every rate 0, plus ``overrides``."""
    kw = dict(dtype="float32", **{**ZERO_RATES, **overrides})
    return JaxAVHuBERTConfig.tiny_test(**kw), AVHuBERTConfig.tiny_test(**kw)


def av_inputs(seed=0, t_video=T):
    """Audio features [B, T, 104], lip clips [B, t_video, 48, 48, 1], a
    padding mask of lengths 7, 4, 2 and pad-suffixed decoder tokens."""
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(B, T, 104)).astype(np.float32)
    video = rng.normal(size=(B, t_video, HW, HW, 1)).astype(np.float32)
    pad = np.arange(T)[None] < np.array([7, 4, 2])[:, None]
    dec = rng.integers(3, 59, size=(B, 6))
    dec[:, 0] = 0
    dec[1, 4:] = 1
    dec[2, 2:] = 1
    return audio, video, pad, dec


def carried(head="seq2seq", seed=0, **overrides):
    """(JAX model, JAX variables, port model in eval mode, port config)."""
    jcfg, pcfg = configs(**overrides)
    audio, video, pad, dec = av_inputs(seed)
    jmodel = (JaxS2T if head == "seq2seq" else JaxCTC)(jcfg)
    kw = dict(decoder_input_ids=dec) if head == "seq2seq" else {}
    init = jax.jit(lambda key, a, v, p: jmodel.init(key, audio=a, video=v, padding_mask=p, **kw))
    variables = perturb(init(jax.random.PRNGKey(seed), audio, video, pad),
                        np.random.default_rng(seed + 100))
    port = build_avhubert(pcfg, head, device="cpu")
    port.load_state_dict(avhubert_state_dict_from_flax(variables["params"],
                                                       variables["batch_stats"]))
    return jmodel, variables, port.eval(), pcfg


def close(got, want, tol=TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    assert np.isfinite(got).all(), err_msg
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module", params=["large", "learned_untied", "post_norm_wide"])
def seq2seq(request):
    """The seq2seq model as the AV-HuBERT large card builds it (sinusoid
    positions, tied output projection, pre-norm decoder), with learned
    positions and a separate output projection, and post-norm (no final
    decoder norm) with a decoder wider than the encoder (the
    cross-attention projects keys and values from the encoder's width)."""
    over = {"large": {},
            "learned_untied": dict(decoder_learned_pos=True, tie_word_embeddings=False),
            "post_norm_wide": dict(decoder_normalize_before=False, decoder_hidden_size=48,
                                   decoder_ffn_dim=96)}[request.param]
    return carried("seq2seq", seed=6, **over)


def test_torch_avhubert_seq2seq_logits_match_jax(seq2seq):
    jmodel, variables, port, _ = seq2seq
    audio, video, pad, dec = av_inputs(7)
    labels = np.where(dec == 1, -100, np.roll(dec, -1, axis=1))
    want = jmodel.apply(variables, audio=audio, video=video, decoder_input_ids=dec,
                        padding_mask=pad, labels=labels)
    with torch.inference_mode():
        got = port(audio=t(audio), video=t(video), decoder_input_ids=t(dec),
                   padding_mask=t(pad), labels=t(labels))
    for key in ("encoder_out", "logits", "loss"):
        close(got[key], want[key], err_msg=key)
    # teacher forcing from the labels alone: shift_right with BOS and pad
    want_shift = jmodel.apply(variables, jnp.asarray(labels), method=JaxS2T.shift_right)
    np.testing.assert_array_equal(port.shift_right(t(labels)).numpy(), np.asarray(want_shift))


def test_torch_avhubert_cached_decode_matches_full_decoding(seq2seq):
    """A 4-token prompt then two single-token steps through the KV cache
    (the cross-attention's K/V precomputed, the padded encoder frames
    masked) against one full teacher-forced decode, and against JAX's
    cached steps."""
    jmodel, variables, port, _ = seq2seq
    audio, video, pad, _ = av_inputs(8)
    tokens = np.random.default_rng(8).integers(3, 59, size=(B, 6))
    tokens[:, 0] = 0
    enc_j = jmodel.apply(variables, audio=audio, video=video, padding_mask=pad,
                         method=JaxS2T.encode)
    full_j, _ = jmodel.apply(variables, tokens, enc_j, pad, method=JaxS2T.decode)
    cache_j = jmodel.apply(variables, enc_j, 8, method=JaxS2T.init_decode_cache)
    with torch.inference_mode():
        enc = port.encode(audio=t(audio), video=t(video), padding_mask=t(pad))
        full, _ = port.decode(t(tokens), enc, t(pad))
        close(full, full_j, err_msg="full decode")
        cache = port.init_decode_cache(enc, 8)
        for lo, hi in ((0, 4), (4, 5), (5, 6)):
            step, cache = port.decode(t(tokens[:, lo:hi]), None, t(pad), cache)
            step_j, cache_j = jmodel.apply(variables, tokens[:, lo:hi], None, pad, cache_j,
                                           method=JaxS2T.decode)
            close(step, full[:, lo:hi].numpy(), err_msg=f"cached {lo}:{hi} vs full")
            close(step, step_j, err_msg=f"cached {lo}:{hi} vs JAX")
        assert int(cache[0]["self"]["index"]) == 6


def test_torch_avhubert_seq2seq_names_round_trip(seq2seq):
    """Both directions of the carrier: the JAX tree went to the port's
    fairseq state dict; the port's state dict (the positional conv as its
    fused kernel, which the converter re-parametrises) goes back through
    ``convert_avhubert_state_dict`` to the same tree. The converter sends
    learned positions to ``embed_positions/embedding``, a level below the
    JAX decoder's own ``embed_positions`` parameter."""
    _, variables, port, _ = seq2seq
    back = back_through_converter(port)
    want = flat_variables(variables)
    if "params/decoder/embed_positions" in want:
        want["params/decoder/embed_positions/embedding"] = want.pop(
            "params/decoder/embed_positions")
    assert_round_trip(back, want)
    assert not any("sinusoid" in k for k in port.state_dict())  # recomputed, not carried


def back_through_converter(port):
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()
          if not k.endswith(("pos_conv.0.weight_g", "pos_conv.0.weight_v"))}
    sd["encoder.w2v_model.encoder.pos_conv.0.weight"] = (
        port.avhubert.encoder.pos_conv[0].kernel().detach().numpy())
    return convert_avhubert_state_dict(sd)


def flat_variables(variables):
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[collection])[0]:
            out[collection + "/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    return out


def assert_round_trip(back, want):
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        if "/pos_conv/" in key:
            continue
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    pos = "params/avhubert/encoder/transformer/pos_conv/"
    kernel, scale = back[pos + "conv/kernel"], back[pos + "WeightNorm_0/conv/kernel/scale"]
    want_k = want[pos + "conv/kernel"]
    want_eff = want[pos + "WeightNorm_0/conv/kernel/scale"] * want_k / np.sqrt(
        (want_k ** 2).sum(axis=(0, 1), keepdims=True))
    np.testing.assert_allclose(kernel * scale / np.sqrt((kernel ** 2).sum(axis=(0, 1),
                                                                          keepdims=True)),
                               want_eff, atol=1e-6, rtol=1e-5)
