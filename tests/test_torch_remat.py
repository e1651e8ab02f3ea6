"""Activation checkpointing of the port (``models/layers.py::remat_block``)
against no checkpointing and against the JAX package's ``remat`` (CPU).

The cases of ``tests/test_remat.py``: remat changes no number (here
bit-equal gradients, with both policies, with every dropout, LayerDrop
and training BatchNorm on, drawn from seeded generators; the running
statistics updated once), the saved activations shrink below half, the
factory plumbs ``remat`` to both stacks, and ``cli.finetune`` takes the
YAML's ``enable_gradient_checkpointing``. Then the port's AV-HuBERT
seq2seq model with remat against the JAX one with remat, every rate 0,
gradients at atol 1e-5 + rtol 1e-4 (fp32 sums in other orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import avhubert_state_dict_from_flax, build_whisper_flamingo
from avsl_tpu_torch.models import layers
from avsl_tpu_torch.models.avhubert import AVHuBERTTransformerEncoder
from test_torch_avhubert_models import av_inputs, carried, close, t
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)

# every training draw of the tower on, and Whisper's residual dropout
RATES = dict(hidden_dropout=0.2, attention_dropout=0.2, activation_dropout=0.2,
             dropout_input=0.2, layerdrop=0.3)


def flamingo_pair(policy):
    """(plain, remat) tiny Whisper-Flamingo models on the same weights, in
    training mode, every tensor trained and the gates nonzero."""
    kw = dict(add_gated_x_attn=1, dropout_rate=0.1, dtype="float32", device="cpu",
              av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32", **RATES))
    plain, _ = build_whisper_flamingo("test", **kw)
    remat, cfg = build_whisper_flamingo("test", remat=True, remat_policy=policy, **kw)
    remat.load_state_dict(plain.state_dict())
    for m in (plain, remat):
        for name, p in m.named_parameters():
            if name.endswith("_gate"):
                p.data.fill_(0.5)
        m.train()
    return plain, remat, cfg


def grads_and_state(model, cfg, seed=0):
    """One training forward and backward: the loss, every gradient, the
    running statistics and the generator's state after."""
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.n_vocab, size=(2, 6)))
    video = torch.from_numpy(rng.normal(size=(2, 6, 48, 48, 1)).astype(np.float32))
    gen = torch.Generator().manual_seed(seed + 11)
    logits = model(mel, toks, video=video, generator=gen)
    loss = (logits.float() ** 2).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    return loss.detach(), grads, stats, gen.get_state()


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_torch_remat_is_bit_identical_with_dropout_and_bn(policy):
    plain, remat, cfg = flamingo_pair(policy)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    loss0, g0, s0, gen0 = grads_and_state(plain, cfg)
    torch.utils.checkpoint.checkpoint = counting
    try:
        loss1, g1, s1, gen1 = grads_and_state(remat, cfg)
    finally:
        torch.utils.checkpoint.checkpoint = real
    # the Whisper encoder's blocks, the tower's ResNet and its blocks; not
    # the text decoder (JAX remats the encoder only)
    assert len(calls) == cfg.n_audio_layer + 1 + remat.video_model.cfg.num_hidden_layers
    assert torch.equal(loss0, loss1)
    assert sorted(g0) == sorted(g1) and len(g0) > 100
    assert all(torch.equal(g0[n], g1[n]) for n in g0), [n for n in g0 if not torch.equal(g0[n], g1[n])]
    assert any(g.abs().sum() > 0 for n, g in g1.items() if "video_model" in n)
    # BatchNorm updated its statistics once (flax updates batch_stats once)
    assert s0 and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in s1.items() if "mean" in k)
    # the generator ends where the forward left it
    assert torch.equal(gen0, gen1)


def test_torch_remat_recompute_draws_the_forward_masks():
    """A block with residual dropout 0.5: the recompute's masks are the
    forward's (else the gradients would differ), and a second backward
    pass recomputes again with them."""
    block = layers.TransformerBlock(16, 2, 32, dtype=torch.float32, dropout=0.5).train()
    x = torch.randn(2, 5, 16, requires_grad=True)
    grads = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(3)
        x.grad = None
        if remat:
            out, _ = layers.remat_block(block, "block", (gen,), x, generator=gen)
        else:
            out, _ = block(x, generator=gen)
        out.sum().backward()
        grads.append((x.grad.clone(), gen.get_state()))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_torch_remat_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        build_whisper_flamingo("test", remat=True, remat_policy="all", device="cpu")


def test_torch_remat_saved_tensor_bytes_below_half():
    """Bytes held between forward and backward on a 6-layer, 256-wide
    encoder at [2, 512]: what autograd saves outside checkpointed blocks
    (``saved_tensors_hooks``) plus what each checkpoint keeps for its
    recompute (its tensor inputs), distinct storages counted once."""
    base = AVHuBERTConfig.tiny_test(dtype="float32", num_hidden_layers=6, hidden_size=256,
                                    intermediate_size=1024, num_attention_heads=4)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 512, 256)).astype(np.float32))

    def held_bytes(cfg):
        torch.manual_seed(0)
        enc = AVHuBERTTransformerEncoder(cfg).eval()
        storages = {}

        def note(tensor):
            if isinstance(tensor, torch.Tensor):
                storages[tensor.untyped_storage().data_ptr()] = tensor.untyped_storage().nbytes()
            return tensor

        real = torch.utils.checkpoint.checkpoint

        def keeping(fn, *args, **kw):
            for a in args:
                note(a)
            return real(fn, *args, **kw)

        torch.utils.checkpoint.checkpoint = keeping
        try:
            with torch.autograd.graph.saved_tensors_hooks(note, lambda t: t):
                out = enc(x.clone().requires_grad_(True))
        finally:
            torch.utils.checkpoint.checkpoint = real
        del out
        return sum(storages.values())

    plain = held_bytes(base)
    remat = held_bytes(dataclasses.replace(base, remat=True))
    assert remat < 0.5 * plain, (remat, plain)


def test_torch_factory_plumbs_remat_to_both_stacks():
    model, w_cfg = build_whisper_flamingo("test", remat=True, device="cpu")
    tower = model.video_model
    assert w_cfg.remat and model.encoder.remat
    assert tower.cfg.remat and tower.encoder.remat and tower.feature_extractor_video.remat
    model2, w2 = build_whisper_flamingo("test", device="cpu")
    assert not (w2.remat or model2.encoder.remat or model2.video_model.encoder.remat)


@pytest.mark.parametrize("flag", [False, True])
def test_torch_finetune_honours_enable_gradient_checkpointing(flag, tmp_path):
    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    cfg = FlamingoTrainConfig(model_name="test", enable_gradient_checkpointing=flag)
    model, w_cfg = finetune.build_model(cfg, get_tokenizer(None, cfg.lang), "cpu", smoke=True)
    assert w_cfg.remat == flag and model.encoder.remat == flag
    assert model.video_model.cfg.remat == flag


def test_torch_avhubert_remat_matches_jax_remat():
    """Every rate 0: the port's seq2seq model with remat (ResNet frontend,
    encoder and decoder blocks) against JAX's with remat, loss and every
    parameter gradient of mean(logits^2), padded frames and tokens."""
    jmodel, variables, port, pcfg = carried("seq2seq", seed=6, remat=True)
    assert pcfg.remat and jmodel.cfg.remat
    audio, video, pad, dec = av_inputs(7)

    def jloss(params):
        out = jmodel.apply({**variables, "params": params}, audio=audio, video=video,
                           decoder_input_ids=dec, padding_mask=pad)
        return jnp.mean(out["logits"] ** 2)

    want_loss, want_grads = jax.value_and_grad(jloss)(variables["params"])
    calls = []
    real = layers.remat_block

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    import avsl_tpu_torch.models.avhubert as avhubert_mod

    avhubert_mod.remat_block = counting
    try:
        out = port(audio=t(audio), video=t(video), decoder_input_ids=t(dec), padding_mask=t(pad))
    finally:
        avhubert_mod.remat_block = real
    assert len(calls) == 1 + pcfg.num_hidden_layers + pcfg.decoder_layers
    loss = (out["logits"] ** 2).mean()
    loss.backward()
    close(loss, want_loss)
    want = avhubert_state_dict_from_flax(jax.device_get(want_grads))
    named = dict(port.named_parameters())
    assert set(want) <= set(named) and len(want) > 50
    for key, w in want.items():
        grad = named[key].grad
        if grad is None:  # not on the path (mask_emb): JAX's gradient is zero
            assert not w.any(), key
        else:
            close(grad, w.numpy(), err_msg=key)


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_torch_remat_under_lora_is_bit_identical(policy):
    """LoRA's merged weights shadow the base's during the forward and are
    shadowed again in the recompute: the adapters' gradients with remat
    equal those without, bit for bit, dropout on, B != 0."""
    from avsl_tpu_torch.models import lora

    plain, remat, cfg = flamingo_pair(policy)
    adapters = lora.init_lora(torch.Generator().manual_seed(0), plain, rank=4)
    gen = torch.Generator().manual_seed(1)
    for ab in adapters.values():
        ab["lora_b"].normal_(0.0, 0.05, generator=gen)
    grads = []
    for base in (plain, remat):
        model = lora.LoraModel(base, {p: {k: t.clone() for k, t in ab.items()}
                                      for p, ab in adapters.items()}, alpha=8.0, rank=4).train()
        _, g, _, _ = grads_and_state(model, cfg)
        grads.append(g)
    assert sorted(grads[0]) == sorted(grads[1]) and len(grads[0]) == 2 * len(adapters)
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    assert all(grads[1][n].any() for n in grads[1] if "video_model" in n)
