"""Span masks of the port against the JAX package (CPU).

``span_mask_from_uniform`` on JAX's own uniforms (``jax.random.uniform(key,
(B, T))``, the draw inside ``avsl_tpu.models.avhubert.span_mask``) gives
JAX's mask exactly, padded and unpadded, including the cases where the
span count is clamped to T, where a row is shorter than a span, and where
a row is empty. The port's own draw keeps JAX's properties
(``tests/test_models.py:239-247``) and its statistics against the
reference's numpy ``compute_mask_indices`` (``_numpy_compute_mask_indices``,
copied from ``tests/test_models.py:249-263``) to the same tolerances as
``:265-320``. ``AVHuBERTModel`` with ``apply_time_mask`` in training: a
given mask takes precedence and the output equals JAX's on carried weights
(atol 1e-5 + rtol 1e-4); a drawn mask is the span mask of the generator's
next uniforms, over the conv stack's output length for a raw waveform,
with a channel mask only when ``mask_feature_prob > 0``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.models.avhubert import AVHuBERTForSpeech2Text as JaxS2T
from avsl_tpu.models.avhubert import span_mask as jax_span_mask
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models.avhubert import AVHuBERTModel, init_weights, span_mask, \
    span_mask_from_uniform
from test_torch_avhubert_models import B, T, av_inputs, carried, close, t
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

# (batch, length, mask_prob, mask_length, row lengths or None)
CASES = {
    "unpadded": (4, 64, 0.65, 10, None),
    "padded": (4, 64, 0.8, 10, [50, 64, 37, 12]),
    "clamped_to_T": (3, 9, 0.9, 1, None),
    "short_rows": (4, 30, 0.5, 10, [30, 9, 1, 0]),
    "fine_spans": (2, 200, 0.3, 5, [200, 151]),
    "channels": (5, 32, 0.5, 4, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_span_mask_on_jax_uniforms_is_jax_mask(case, seed):
    b, length, prob, span, lengths = CASES[case]
    pad = None if lengths is None else np.arange(length)[None] < np.asarray(lengths)[:, None]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_span_mask(key, b, length, prob, span,
                                    None if pad is None else jnp.asarray(pad)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (b, length))))
    got = span_mask_from_uniform(u, prob, span, t(pad))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_span_mask_zero_probability_and_empty_length():
    g = torch.Generator().manual_seed(0)
    assert not span_mask(g, 3, 20, 0.0, 5).any()
    assert span_mask(g, 3, 0, 0.5, 5).shape == (3, 0)
    with pytest.raises(ValueError, match="Generator"):
        span_mask(None, 3, 20, 0.5, 5)


def test_torch_span_mask_properties():
    """``tests/test_models.py:239-247`` on the port's draw."""
    g = torch.Generator().manual_seed(0)
    padding = torch.cat([torch.ones(4, 50, dtype=torch.bool), torch.zeros(4, 14, dtype=torch.bool)],
                        dim=1)
    m = span_mask(g, 4, 64, mask_prob=0.8, mask_length=10, padding_mask=padding).numpy()
    assert m.shape == (4, 64)
    assert m.any()
    assert not m[:, 50:].any()  # never masks padding


def _numpy_compute_mask_indices(rng, bsz, T, mask_prob, mask_length, sz=None):
    """Clean-room numpy re-derivation of the reference's default
    compute_mask_indices path (utils/model_utils.py:4-114,
    no_overlap=False, static lengths): per item, round(prob*sz/L) span
    starts drawn uniformly WITHOUT replacement from [0, sz-L), each span
    masking L steps, indices clipped to < sz."""
    sz = T if sz is None else sz
    num = max(1, int((mask_prob + 1e-5) * sz / float(mask_length) + 0.5))
    mask = np.zeros((bsz, T), bool)
    for i in range(bsz):
        starts = rng.choice(max(sz - mask_length, 1), size=min(num, max(sz - mask_length, 1)),
                            replace=False)
        for s in starts:
            mask[i, s:min(s + mask_length, sz)] = True
    return mask


def _run_lengths(m):
    out = []
    for row in m:
        d = np.diff(np.concatenate([[0], row.astype(int), [0]]))
        out.extend(np.nonzero(d == -1)[0] - np.nonzero(d == 1)[0])
    return np.array(out)


def test_torch_span_mask_statistical_parity_with_reference():
    """Mask rate and run lengths over 30 draws against the reference's
    sampler, no padding (``tests/test_models.py:265-297``)."""
    B_, T_, P, L = 16, 200, 0.65, 10
    rng = np.random.default_rng(0)
    ref = np.concatenate([_numpy_compute_mask_indices(rng, B_, T_, P, L) for _ in range(30)])
    g = torch.Generator().manual_seed(0)
    ours = np.concatenate([span_mask(g, B_, T_, P, L).numpy() for _ in range(30)])
    assert abs(ours.mean() - ref.mean()) < 0.02, (ours.mean(), ref.mean())
    rl_ref, rl_ours = _run_lengths(ref), _run_lengths(ours)
    assert abs(rl_ours.mean() - rl_ref.mean()) < 1.5, (rl_ours.mean(), rl_ref.mean())
    assert rl_ours.min() >= 1 and rl_ref.min() >= 1


def test_torch_span_mask_padded_rate_close_to_reference():
    """Unpadded-region mask rates within 5 % of the reference's with 20 %
    padding (``tests/test_models.py:300-320``)."""
    B_, T_, SZ, P, L = 16, 200, 160, 0.65, 10
    rng = np.random.default_rng(1)
    ref = np.concatenate([_numpy_compute_mask_indices(rng, B_, T_, P, L, sz=SZ)
                          for _ in range(30)])
    padding = torch.zeros(B_, T_, dtype=torch.bool)
    padding[:, :SZ] = True
    g = torch.Generator().manual_seed(1)
    ours = np.concatenate([span_mask(g, B_, T_, P, L, padding_mask=padding).numpy()
                           for _ in range(30)])
    assert not ours[:, SZ:].any()
    assert abs(ours[:, :SZ].mean() - ref[:, :SZ].mean()) < 0.05


@pytest.fixture(scope="module")
def carried_audio():
    """The tiny AV seq2seq model on JAX's weights, every rate 0, masks at
    0.5 x 4; in training its BatchNorm keeps the running statistics
    (``use_running_average=True``), so nothing is updated."""
    return carried("seq2seq", seed=5, mask_prob_audio=0.5, mask_length_audio=4)


def test_torch_apply_time_mask_given_mask_matches_jax(carried_audio):
    """In training with ``apply_time_mask``, masks the caller passes take
    precedence over the draw, in both packages: equal outputs."""
    jmodel, variables, port, pcfg = carried_audio
    audio, video, pad, _ = av_inputs(9)
    rng = np.random.default_rng(2)
    fmask = rng.random((B, T)) < 0.4
    cmask = rng.random((B, pcfg.hidden_size)) < 0.2
    for extra in ({"feature_mask": fmask}, {"feature_mask": fmask, "channel_mask": cmask}):
        want = jmodel.apply(variables, audio=audio, video=video, padding_mask=pad,
                            apply_time_mask=True, deterministic=False, use_running_average=True,
                            method=JaxS2T.encode, rngs={"mask": jax.random.PRNGKey(0)}, **extra)
        model = port.avhubert.train()
        try:
            got = model(audio=t(audio), video=t(video), padding_mask=t(pad),
                        apply_time_mask=True, use_running_average=True,
                        generator=torch.Generator().manual_seed(0),
                        **{k: t(v) for k, v in extra.items()})
        finally:
            model.eval()
        close(got, want, err_msg=str(sorted(extra)))


def _drawn_vs_given(model, gen_seed, **inputs):
    """(output with the mask drawn in training, output with the mask that
    draw makes passed in, that mask)."""
    model.train()
    try:
        drawn = model(**inputs, apply_time_mask=True,
                      generator=torch.Generator().manual_seed(gen_seed))
        cfg = model.cfg
        g = torch.Generator().manual_seed(gen_seed)
        src = inputs["audio"] if inputs.get("audio") is not None else inputs["video"]
        length = src.shape[1]
        if cfg.use_conv_audio_frontend and src.ndim == 2:
            from avsl_tpu_torch.models.avhubert import Wav2Vec2FeatureEncoder

            length = Wav2Vec2FeatureEncoder.output_length(cfg, length)
        prob, span = ((cfg.mask_prob_audio, cfg.mask_length_audio)
                      if inputs.get("audio") is not None
                      else (cfg.mask_prob_image, cfg.mask_length_image))
        fmask = span_mask(g, src.shape[0], length, prob, span, inputs.get("padding_mask"))
        extra = {"feature_mask": fmask}
        if cfg.mask_feature_prob > 0:
            extra["channel_mask"] = span_mask(g, src.shape[0], cfg.hidden_size,
                                              cfg.mask_feature_prob, cfg.mask_feature_length)
        given = model(**inputs, **extra, generator=torch.Generator().manual_seed(99))
        plain = model(**inputs, generator=torch.Generator().manual_seed(gen_seed))
    finally:
        model.eval()
    return drawn, given, plain, fmask


def test_torch_apply_time_mask_draws_the_span_mask(carried_audio):
    """The drawn time mask is the span mask of the generator's next
    uniforms at the audio rates, with padding, and it changes the output."""
    _, _, port, _ = carried_audio
    audio, video, pad, _ = av_inputs(10)
    with torch.no_grad():
        drawn, given, plain, fmask = _drawn_vs_given(port.avhubert, 3, audio=t(audio),
                                                     video=t(video), padding_mask=t(pad),
                                                     use_running_average=True)
    assert fmask.any() and not (fmask & ~t(pad)).any()
    torch.testing.assert_close(drawn, given, atol=0, rtol=0)
    assert not torch.allclose(drawn, plain)


@pytest.mark.parametrize("variant", ["video_rates", "raw_wave", "channels"])
def test_torch_apply_time_mask_variants(variant):
    """Video only: the image rates; a raw waveform (the conv frontend): the
    mask over the conv stack's output frames; ``mask_feature_prob`` > 0: a
    channel mask over the hidden width too (the drawn output equals the
    one given both masks; with the knob at 0 none is drawn)."""
    over = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                dropout_input=0.0, layerdrop=0.0, modality_dropout=0.0, dtype="float32")
    if variant == "video_rates":
        cfg = AVHuBERTConfig.tiny_test(use_audio=False, modality_fuse="add",
                                       mask_prob_image=0.6, mask_length_image=2, **over)
        inputs = {"video": torch.from_numpy(
            np.random.default_rng(0).normal(size=(2, 9, 24, 24, 1)).astype(np.float32))}
    elif variant == "raw_wave":
        cfg = AVHuBERTConfig.tiny_test(use_visual=False, modality_fuse="add",
                                       use_conv_audio_frontend=True, conv_dim=(16,) * 3,
                                       conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                                       mask_prob_audio=0.6, mask_length_audio=2, **over)
        inputs = {"audio": torch.from_numpy(
            np.random.default_rng(1).normal(size=(2, 800)).astype(np.float32))}
    else:
        cfg = AVHuBERTConfig.tiny_test(use_visual=False, modality_fuse="add",
                                       mask_feature_prob=0.5, mask_feature_length=4,
                                       mask_prob_audio=0.3, mask_length_audio=2, **over)
        inputs = {"audio": torch.from_numpy(
            np.random.default_rng(2).normal(size=(2, 12, 104)).astype(np.float32))}
    model = AVHuBERTModel(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        drawn, given, plain, fmask = _drawn_vs_given(model, 4, **inputs)
    assert fmask.shape == drawn.shape[:2] and fmask.any()
    torch.testing.assert_close(drawn, given, atol=0, rtol=0)
    assert not torch.allclose(drawn, plain)
