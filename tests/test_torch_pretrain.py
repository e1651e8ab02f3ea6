"""AV-HuBERT masked-cluster pretraining of the port (``models/pretrain.py``,
``avhubert_pretrain_loss_fn``) against the JAX package (CPU, fp32).

The ten cases of ``tests/test_pretrain.py`` on the port: logit shapes and
the cosine bound; padding out of the mask and the loss; the skip gates;
the untied multi-group projection; the dot similarity; learnability
(masked accuracy above 0.6 after 60 Adam steps, chance 0.25); the
objective's feature penalty; the pretrained encoder loaded into the
fine-tune heads by ``partial_load`` (every encoder tensor moved under
``encoder.w2v_model.``, only ``final_proj`` and ``label_embs_concat``
unexpected and only the head missing); the layer tap; and
``extract_layer_features``. Then JAX against the port on weights carried
by ``pretrain_state_dict_from_flax``, under one shared feature mask, in
training mode with every rate 0 (BatchNorm on the batch's statistics):
the logits, ``pretrain_loss`` with all its metrics and the feature
penalty, and the gradients of every tensor, audio-only and AV, tied and
untied, cosine and dot (atol 1e-5 + rtol 1e-4; a gradient's atol is 1e-4
of its tensor's largest element where that is more, the rule of
``tests/test_torch_avhubert_train.py``; a logit's is 1e-5 of its tensor's
largest logit where that is more, the dot logits reaching 40). The
port's loss closure draws its mask from the generator it is given, in
eval too.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.pretrain import AVHuBERTForPretraining as JaxPretrain
from avsl_tpu.models.pretrain import extracted_features_from as jax_extracted
from avsl_tpu.models.pretrain import pretrain_loss as jax_pretrain_loss
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import build_avhubert, pretrain_state_dict_from_flax
from avsl_tpu_torch.models.avhubert import span_mask
from avsl_tpu_torch.models.intermediates import collect_intermediates
from avsl_tpu_torch.models.pretrain import (
    extract_layer_features,
    extracted_features_from,
    pretrain_loss,
)
from avsl_tpu_torch.train import TrainState, make_train_step
from avsl_tpu_torch.train.checkpoints import partial_load
from avsl_tpu_torch.train.objectives import avhubert_pretrain_loss_fn
from avsl_tpu_torch.train.optim import constant_adamw
from test_torch_avhubert_models import TOL, ZERO_RATES, close, perturb
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

B, T, N_CLS = 2, 32, 11


def _audio_cfg(**kw):
    return AVHuBERTConfig.tiny_test(dtype="float32", use_visual=False, modality_fuse="add",
                                    mask_prob_audio=0.5, mask_length_audio=4, **kw)


def _model(cfg, num_classes=(N_CLS,), seed=0):
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(rng.normal(size=(B, T, cfg.audio_feat_dim)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, min(num_classes), (B, T)))
    return build_avhubert(cfg, "pretrain", device="cpu", seed=seed,
                          num_classes=num_classes), audio, targets


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_torch_pretrain_forward_shapes_and_cosine_bound():
    cfg = _audio_cfg()
    model, audio, targets = _model(cfg)
    with torch.no_grad():
        out = model(audio=audio, targets=targets, generator=_gen(7))
    (logits,) = out["logits"]
    assert logits.shape == (B, T, N_CLS) and logits.dtype == torch.float32
    assert out["mask"].shape == (B, T) and out["mask"].dtype == torch.bool
    assert 0.1 < float(out["mask"].float().mean()) < 0.9
    assert float(logits.abs().max()) <= 1.0 / cfg.logit_temp + 1e-4
    loss, metrics = pretrain_loss(out, cfg)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(metrics[k]) for k in ("loss_m", "loss_u", "acc_m", "acc_u"))


def test_torch_pretrain_padding_excluded_from_mask_and_loss():
    cfg = _audio_cfg()
    model, audio, targets = _model(cfg)
    padding = torch.zeros(B, T)
    padding[:, :T // 2] = 1.0
    with torch.no_grad():
        out = model(audio=audio, targets=targets, padding_mask=padding, generator=_gen(3))
    assert not out["mask"][:, T // 2:].any()
    loss_a, _ = pretrain_loss(out, cfg)
    out2 = dict(out)
    tgt = out["targets"].clone()
    tgt[:, T // 2:] = (tgt[:, T // 2:] + 1) % N_CLS
    out2["targets"] = tgt
    loss_b, _ = pretrain_loss(out2, cfg)
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-6)


def test_torch_pretrain_skip_gates_zero_their_terms():
    base = _audio_cfg()
    model, audio, targets = _model(base)
    with torch.no_grad():
        out = model(audio=audio, targets=targets, generator=_gen(5))
    _, full = pretrain_loss(out, base)
    _, skip_m = pretrain_loss(out, _audio_cfg(skip_masked=True))
    _, skip_u = pretrain_loss(out, _audio_cfg(skip_nomask=True))
    assert float(skip_m["loss_m"]) == 0.0 and float(skip_u["loss_u"]) == 0.0
    assert float(skip_m["loss_u"]) == pytest.approx(float(full["loss_u"]), rel=1e-6)
    assert float(skip_u["loss_m"]) == pytest.approx(float(full["loss_m"]), rel=1e-6)


def test_torch_pretrain_untied_multi_group_projection():
    cfg = _audio_cfg(untie_final_proj=True)
    groups = (N_CLS, 5)
    model, audio, _ = _model(cfg, num_classes=groups)
    rng = np.random.default_rng(1)
    targets = torch.from_numpy(np.stack([rng.integers(0, g, (B, T)) for g in groups], axis=-1))
    with torch.no_grad():
        out = model(audio=audio, targets=targets, generator=_gen(9))
    assert [tuple(lg.shape) for lg in out["logits"]] == [(B, T, groups[0]), (B, T, groups[1])]
    assert model.final_proj.weight.shape[0] == cfg.final_dim * 2
    assert tuple(model.label_embs_concat.shape) == (sum(groups), cfg.final_dim)
    assert torch.isfinite(pretrain_loss(out, cfg)[0])


def test_torch_pretrain_dot_sim_type():
    cfg = _audio_cfg(sim_type="dot")
    model, audio, targets = _model(cfg)
    with torch.no_grad():
        out = model(audio=audio, targets=targets, generator=_gen(2))
    assert torch.isfinite(pretrain_loss(out, cfg)[0])


def test_torch_pretrain_learnability_audio_only():
    """Masked prediction of input-derived cluster ids beats chance (0.25)
    by far after 60 Adam steps (the gradient flows through ``mask_emb``,
    the codebook and the encoder)."""
    cfg = _audio_cfg(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                     dropout_input=0.0, dropout_features=0.0, modality_dropout=0.0,
                     layerdrop=0.0, feature_grad_mult=1.0)
    model = build_avhubert(cfg, "pretrain", device="cpu", num_classes=(4,))
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(4, T, cfg.audio_feat_dim)).astype(np.float32)
    half = cfg.audio_feat_dim // 2
    tid = ((audio[..., :half].mean(-1) > 0).astype(np.int64) * 2
           + (audio[..., half:].mean(-1) > 0).astype(np.int64))
    batch = {"audio": audio, "targets": tid}
    state = TrainState.create(model, constant_adamw(dict(model.named_parameters()), 3e-3,
                                                    weight_decay=0.0))
    step = make_train_step(avhubert_pretrain_loss_fn(model, train=True))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(60)]
    assert all(np.isfinite(losses))
    with torch.no_grad():
        _, m = avhubert_pretrain_loss_fn(model, train=False)(
            {k: torch.as_tensor(v) for k, v in batch.items()}, _gen(42))
    assert float(m["acc_m"]) > 0.6, float(m["acc_m"])
    assert losses[-1] < losses[0]


def test_torch_pretrain_objective_reports_feature_penalty():
    cfg = _audio_cfg()
    model, audio, targets = _model(cfg)
    batch = {"audio": audio, "targets": targets}
    with torch.no_grad():
        loss, metrics = avhubert_pretrain_loss_fn(model, train=False)(batch, _gen(0))
        loss0, _ = avhubert_pretrain_loss_fn(model, train=False, feature_pen_weight=0.0)(
            batch, _gen(0))
    assert "features_pen" in metrics and torch.isfinite(metrics["features_pen"])
    assert float(loss) > float(loss0)
    with pytest.raises(ValueError, match="Generator"):
        avhubert_pretrain_loss_fn(model, train=False)(batch, None)


@pytest.mark.parametrize("head", ["ctc", "seq2seq"])
def test_torch_pretrained_encoder_loads_into_finetune_heads(head):
    """The pretraining state dict (fairseq ``AVHubertModel``'s names, BatchNorm
    statistics included) into a fine-tune head: every encoder tensor moves
    under ``encoder.w2v_model.``; the rest is the expected triage."""
    cfg = AVHuBERTConfig.tiny_test(dtype="float32")
    pre = build_avhubert(cfg, "pretrain", device="cpu", num_classes=(N_CLS,))
    pre_sd = pre.state_dict()
    ft = build_avhubert(cfg, head, device="cpu", seed=1)
    _, report = partial_load(ft, pre_sd)
    encoder_keys = [k for k in pre_sd if not k.startswith(("final_proj.", "label_embs_concat"))]
    assert sorted(report["loaded"]) == sorted("encoder.w2v_model." + k for k in encoder_keys)
    assert sorted(report["unexpected"]) == ["final_proj.bias", "final_proj.weight",
                                            "label_embs_concat"]
    head_prefix = "ctc_head" if head == "ctc" else "decoder."
    assert report["missing"] and all(k.startswith(head_prefix) for k in report["missing"])
    assert not report["shape_mismatch"]
    got = ft.state_dict()
    for k in encoder_keys:
        torch.testing.assert_close(got["encoder.w2v_model." + k], pre_sd[k], atol=0, rtol=0)


def test_torch_output_layer_tap_semantics():
    cfg = _audio_cfg()
    model, audio, _ = _model(cfg)
    with torch.no_grad():
        full = model.extract_features(audio=audio[:, :16])
        l1 = model.extract_features(audio=audio[:, :16], output_layer=1)
        l2 = model.extract_features(audio=audio[:, :16], output_layer=2)
    assert full.shape == l1.shape == l2.shape
    assert not torch.allclose(l1, l2) and not torch.allclose(l2, full)


def test_torch_extract_layer_features_helper():
    cfg = _audio_cfg()
    model, audio, _ = _model(cfg)
    model.train()
    feats = extract_layer_features(model, 1, audio=audio)
    assert model.training  # the mode is put back
    assert feats.shape == (B, T, cfg.hidden_size) and torch.isfinite(feats).all()
    torch.testing.assert_close(extract_layer_features(model, 1, audio=audio), feats, atol=0,
                               rtol=0)


# ---------------------------------------------------------------------------
# against the JAX package on carried weights
# ---------------------------------------------------------------------------

VARIANTS = {
    "audio_cosine_untied": dict(use_visual=False, modality_fuse="add"),
    "av_cosine_tied": dict(untie_final_proj=False),
    "av_dot_untied_two_groups": dict(sim_type="dot"),
    "audio_dot_tied": dict(use_visual=False, modality_fuse="add", untie_final_proj=False,
                           sim_type="dot"),
}
GROUPS = {"av_dot_untied_two_groups": (N_CLS, 5)}


def _carried(variant):
    kw = dict(dtype="float32", **ZERO_RATES, **VARIANTS[variant])
    jcfg, pcfg = JaxAVHuBERTConfig.tiny_test(**kw), AVHuBERTConfig.tiny_test(**kw)
    groups = GROUPS.get(variant, (N_CLS,))
    rng = np.random.default_rng(3)
    inputs = {"audio": rng.normal(size=(B, 9, 104)).astype(np.float32),
              "padding_mask": np.arange(9)[None] < np.array([9, 6])[:, None]}
    if pcfg.use_visual:
        inputs["video"] = rng.normal(size=(B, 9, 24, 24, 1)).astype(np.float32)
    targets = np.stack([rng.integers(0, g, (B, 9)) for g in groups], axis=-1)
    jmodel = JaxPretrain(jcfg, num_classes=groups)
    variables = jax.jit(lambda key, i: jmodel.init({"params": key, "mask": key}, **i,
                                                   deterministic=True))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in inputs.items()})
    variables = perturb(jax.device_get(variables), np.random.default_rng(4))
    port = build_avhubert(pcfg, "pretrain", device="cpu", num_classes=groups)
    port.load_state_dict(pretrain_state_dict_from_flax(variables["params"],
                                                       variables.get("batch_stats")))
    fmask = rng.random((B, 9)) < 0.5
    return jmodel, variables, port, pcfg, inputs, targets, fmask


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_torch_pretrain_matches_jax(variant):
    jmodel, variables, port, pcfg, inputs, targets, fmask = _carried(variant)
    jcfg = jmodel.cfg

    def jax_loss(params):
        var = {"params": params}
        mutable = ["intermediates"]
        if "batch_stats" in variables:
            var["batch_stats"] = variables["batch_stats"]
            mutable.append("batch_stats")
        out, upd = jmodel.apply(var, **{k: jnp.asarray(v) for k, v in inputs.items()},
                                targets=jnp.asarray(targets), feature_mask=jnp.asarray(fmask),
                                deterministic=False, mutable=mutable)
        loss, metrics = jax_pretrain_loss(out, jcfg,
                                          feature_pen=jax_extracted(upd["intermediates"]))
        return loss, (metrics, out["logits"])

    (want, (want_m, want_logits)), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    port = copy.deepcopy(port).train()
    with collect_intermediates() as inter:
        out = port(**{k: torch.as_tensor(v) for k, v in inputs.items()},
                   targets=torch.as_tensor(targets), feature_mask=torch.as_tensor(fmask))
    loss, metrics = pretrain_loss(out, pcfg, feature_pen=extracted_features_from(inter))
    loss.backward()
    for g, (got, w) in enumerate(zip(out["logits"], want_logits)):
        # a dot logit sums products up to its tensor's largest logit (40
        # with sim_type "dot"): its rounding goes with that scale
        scale = float(np.abs(np.asarray(w)).max())
        close(got, w, tol=dict(TOL, atol=max(TOL["atol"], 1e-5 * scale)), err_msg=f"logits {g}")
    close(loss, want, err_msg="loss")
    assert sorted(metrics) == sorted(want_m)
    for key in want_m:
        close(metrics[key], want_m[key], err_msg=key)
    want_sd = pretrain_state_dict_from_flax(jax.device_get(want_g))
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want_sd)
    for name, p in named.items():
        w = want_sd[name].numpy()
        tol = dict(TOL, atol=max(TOL["atol"], 1e-4 * float(np.abs(w).max())))
        close(p.grad, w, tol=tol, err_msg=name)
    assert float(named["mask_emb"].grad.abs().max()) > 0  # the mask reached the loss


def test_torch_pretrain_loss_fn_draws_its_mask():
    """``avhubert_pretrain_loss_fn`` in eval: the span mask is the draw of
    the given generator (the same loss as the forward given that mask);
    targets and padding are cut to the output length."""
    cfg = _audio_cfg()
    model, audio, targets = _model(cfg)
    pad = torch.arange(T)[None] < torch.tensor([T, 20])[:, None]
    batch = {"audio": audio, "targets": targets, "padding_mask": pad}
    with torch.no_grad():
        loss, metrics = avhubert_pretrain_loss_fn(model, train=False)(batch, _gen(6))
        fmask = span_mask(_gen(6), B, T, cfg.mask_prob_audio, cfg.mask_length_audio, pad)
        with collect_intermediates() as inter:
            out = model(audio=audio, targets=targets, padding_mask=pad, feature_mask=fmask)
        want, want_m = pretrain_loss(out, cfg, feature_pen=extracted_features_from(inter))
    assert not model.training
    torch.testing.assert_close(loss, want, atol=0, rtol=0)
    torch.testing.assert_close(metrics["acc_m"], want_m["acc_m"], atol=0, rtol=0)
