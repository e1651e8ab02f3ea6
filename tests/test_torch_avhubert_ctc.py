"""AV-HuBERT CTC head of the port against the JAX package on carried
weights (CPU, fp32): logits with padded frames, the carrier both ways,
the CTC loss (the optax recursion in torch ops) on repeated labels, a row
without labels, a row whose labels cannot fit in its frames and padded
frames, with its gradient; the raw-waveform audio frontend; and what
the heads refuse. Carriers and tolerances are those of
``tests/test_torch_avhubert_models.py`` (atol 1e-5 + rtol 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.models.avhubert import AVHuBERTForSpeech2Text as JaxS2T
from avsl_tpu.models.avhubert import ctc_loss as jax_ctc_loss
from avsl_tpu_torch.models import avhubert_state_dict_from_flax, build_avhubert
from avsl_tpu_torch.models.avhubert import ctc_loss, optax_ctc_loss
from test_torch_avhubert_models import (
    B,
    assert_round_trip,
    av_inputs,
    back_through_converter,
    carried,
    close,
    configs,
    flat_variables,
    perturb,
    t,
)
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)


def test_torch_avhubert_conv_audio_frontend_matches_jax():
    """The raw-waveform frontend (``use_conv_audio_frontend``): valid
    convolutions, the fp32 GroupNorm after the first, GELU."""
    over = dict(use_conv_audio_frontend=True, conv_dim=(16, 24), conv_stride=(5, 2),
                conv_kernel=(10, 3), use_visual=False, modality_fuse="add")
    jcfg, pcfg = configs(**over)
    rng = np.random.default_rng(5)
    wave = (0.3 * rng.standard_normal((2, 90))).astype(np.float32)  # -> 8 frames
    dec = rng.integers(3, 59, size=(2, 4))
    jmodel = JaxS2T(jcfg)
    variables = perturb(jmodel.init(jax.random.PRNGKey(5), audio=wave, decoder_input_ids=dec), rng)
    port = build_avhubert(pcfg, "seq2seq", device="cpu").eval()
    port.load_state_dict(avhubert_state_dict_from_flax(variables["params"]))
    want = jmodel.apply(variables, audio=wave, decoder_input_ids=dec)
    with torch.inference_mode():
        got = port(audio=t(wave), decoder_input_ids=t(dec))
    assert want["encoder_out"].shape[1] == 8
    for key in ("encoder_out", "logits"):
        close(got[key], want[key], err_msg=key)



@pytest.fixture(scope="module")
def ctc_model():
    return carried("ctc", seed=9)


def test_torch_avhubert_ctc_logits_and_names_match_jax(ctc_model):
    """CTC logits with padded frames, and the carrier both ways; the JAX
    converter has no rule for the head and leaves it at ``ctc_head/*``."""
    jmodel, variables, port, _ = ctc_model
    audio, video, pad, _ = av_inputs(10)
    want = jmodel.apply(variables, audio=audio, video=video, padding_mask=pad)
    with torch.inference_mode():
        got = port(audio=t(audio), video=t(video), padding_mask=t(pad))
    assert got.dtype == torch.float32
    close(got, want)
    back = back_through_converter(port)
    want_flat = flat_variables(variables)
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(back.pop(f"ctc_head/{leaf}"),
                                      want_flat.pop(f"params/ctc_head/{leaf}"))
    assert_round_trip(back, want_flat)


def ctc_cases():
    """Logits [4, 12, 9] and labels [4, 6] (blank 1 = pad): repeated labels;
    no labels; six distinct labels in three frames (infeasible); and the
    last 5 of 12 frames padded."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(4, 12, 9)).astype(np.float32)
    labels = np.full((4, 6), 1, np.int64)
    label_pad = np.ones((4, 6), np.float32)
    labels[0, :5] = [3, 3, 5, 5, 5]
    label_pad[0, :5] = 0
    labels[2] = [2, 3, 4, 5, 6, 7]
    label_pad[2] = 0
    labels[3, :3] = [4, 4, 6]
    label_pad[3, :3] = 0
    logit_pad = np.zeros((4, 12), np.float32)
    logit_pad[2, 3:] = 1  # row 2: 3 frames for 6 labels
    logit_pad[3, 7:] = 1
    return logits, logit_pad, labels, label_pad


def test_torch_ctc_loss_matches_optax():
    """The port's optax recursion per row, the guarded mean, and the
    gradient the CTC head trains on, against ``optax.ctc_loss`` and the
    JAX ``ctc_loss``. The infeasible row gets a large finite loss (optax's
    log epsilon), not inf, so the guard keeps it, as in JAX."""
    import optax

    logits, logit_pad, labels, label_pad = ctc_cases()
    want_rows = np.asarray(optax.ctc_loss(logits, logit_pad, labels, label_pad, blank_id=1))
    got_rows = optax_ctc_loss(t(logits), t(logit_pad), t(labels), t(label_pad), blank_id=1)
    close(got_rows, want_rows)
    assert np.isfinite(want_rows).all() and want_rows[2] > 1e4
    want = jax_ctc_loss(logits, logit_pad, labels, label_pad, blank_id=1)
    x = t(logits).requires_grad_()
    got = ctc_loss(x, t(logit_pad), t(labels), t(label_pad), blank_id=1)
    close(got, want)
    got.backward()
    want_grad = np.asarray(jax.grad(lambda z: jax_ctc_loss(z, logit_pad, labels, label_pad, 1))(
        jnp.asarray(logits)))
    feasible = [0, 1, 3]
    close(x.grad[feasible], want_grad[feasible])
    # the infeasible row's scores sit near -1e5, where fp32 resolves only
    # 2^-7: its posteriors, and so its gradient, agree to about 1 % of the
    # row's largest element in both implementations' summation orders
    np.testing.assert_allclose(x.grad[2].numpy(), want_grad[2],
                               atol=1e-2 * np.abs(want_grad[2]).max(), rtol=0)
    # the guard drops the label-less row: mean over 4 rows of the other three
    np.testing.assert_allclose(float(got), (want_rows.sum() - want_rows[1]) / 4, rtol=1e-5)


def test_torch_ctc_loss_of_the_model_matches_jax(ctc_model):
    """The CTC head's loss on its own logits, frames padded as the CLI
    pads them."""
    jmodel, variables, port, _ = ctc_model
    audio, video, pad, _ = av_inputs(12)
    _, _, labels, label_pad = ctc_cases()
    labels, label_pad = labels[:B], label_pad[:B]
    logit_pad = 1.0 - pad.astype(np.float32)
    logits_j = jmodel.apply(variables, audio=audio, video=video, padding_mask=pad)
    want = jax_ctc_loss(logits_j, logit_pad, labels, label_pad, blank_id=1)
    with torch.inference_mode():
        logits = port(audio=t(audio), video=t(video), padding_mask=t(pad))
        got = ctc_loss(logits, t(logit_pad), t(labels), t(label_pad), blank_id=1)
    close(got, want)


def test_torch_avhubert_heads_refuse_what_is_not_ported():
    _, pcfg = configs()
    with pytest.raises(ValueError, match="head"):
        build_avhubert(pcfg, "lm", device="cpu")
    # the pretraining head, the MoE FFN and span masking are ported
    assert type(build_avhubert(pcfg, "pretrain", device="cpu")).__name__ == \
        "AVHuBERTForPretraining"
    moe = build_avhubert(dataclasses.replace(pcfg, n_experts=4), "ctc", device="cpu")
    assert any(n.endswith("mlp.router") for n, _ in moe.named_parameters())
    model = build_avhubert(pcfg, "seq2seq", device="cpu").train()
    audio, video, pad, dec = av_inputs(13)
    with torch.no_grad():
        out = model(audio=t(audio), video=t(video), decoder_input_ids=t(dec),
                    apply_time_mask=True, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(out["logits"]).all())
