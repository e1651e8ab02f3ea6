"""A known behaviour of the reference that LoRA on the video tower meets
(CPU, fp32): an item with no lip clip is an all-zero clip, and through a
freshly initialised tower every LayerNorm then sees zero variance, a
gradient gain of 1/sqrt(eps) = 316 each. LoRA's backward overflows
through 12 pre-norm blocks in JAX and in the port alike, and stays finite
through 2 (the AV-HuBERT large tower has 24). The card gate at the
repository root gives its LoRA phase's rows seeded lip frames for that
reason.
"""

import numpy as np
import torch

import jax

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models import lora as jlora
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import build_whisper_flamingo, lora, whisper_state_dict_from_flax
from test_torch_flamingo_common import one_torch_thread  # noqa: F401 (fixture)


def test_torch_lora_zero_clip_overflows_in_a_deep_tower_as_in_jax():
    """A known behaviour of the reference: an item with no lip clip is an
    all-zero clip, every LayerNorm of the freshly initialised tower then
    sees zero variance (a gradient gain of 1/sqrt(eps) each), and LoRA's
    backward through 12 pre-norm blocks overflows; JAX's gradients are
    non-finite there too, and finite through 2 blocks."""
    rates = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                 dropout_input=0.0, layerdrop=0.0, modality_dropout=0.0)
    mel = np.random.default_rng(0).normal(size=(1, 80, 100)).astype(np.float32)
    toks = np.zeros((1, 6), np.int64)
    video = np.zeros((1, 6, 48, 48, 1), np.float32)
    for layers, finite in ((2, True), (12, False)):
        jmodel, cfg = jax_build("test", add_gated_x_attn=1, dtype="float32",
                                av_hubert_cfg=JaxAVHuBERTConfig.tiny_test(
                                    dtype="float32", num_hidden_layers=layers, **rates))
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), mel, toks, video=video)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: np.full_like(x, 0.5) if str(p[-1].key).endswith("_gate") else x,
            variables["params"])
        tree = jlora.init_lora(jax.random.PRNGKey(1), params, 4)

        def loss(adapters):
            out = jmodel.apply({"params": jlora.merge_lora(params, adapters, 8.0, 4),
                                "batch_stats": variables["batch_stats"]}, mel, toks, video=video)
            return (out ** 2).mean()

        jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(loss))(tree))
        assert all(np.isfinite(np.asarray(g)).all() for g in jgrads) == finite, layers
        port, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                         param_dtype="float32", device="cpu",
                                         av_hubert_cfg=AVHuBERTConfig.tiny_test(
                                             dtype="float32", num_hidden_layers=layers, **rates))
        port.load_state_dict(whisper_state_dict_from_flax(params, n_audio_ctx=cfg.n_audio_ctx,
                                                          batch_stats=variables["batch_stats"]))
        model = lora.LoraModel(port, lora.lora_from_flax(jax.device_get(tree)), 8.0, 4).eval()
        (model(torch.as_tensor(mel), torch.as_tensor(toks), video=torch.as_tensor(video)) ** 2
         ).mean().backward()
        grads = [p.grad for p in model.parameters()]
        assert all(bool(torch.isfinite(g).all()) for g in grads) == finite, layers
