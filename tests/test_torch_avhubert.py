"""Port AV-HuBERT video tower against the JAX one on carried weights (CPU, fp32).

The JAX tiny AV-HuBERT (``AVHuBERTConfig.tiny_test``: 32 wide, 2 layers,
2 heads of 16, an 8-tap positional conv in 2 groups, the tiny ResNet) is
initialised, every param gets seeded noise and every BatchNorm running
statistic is perturbed (mean noise, var = 1 + |noise|); the same numbers
go to the port through its weight carrier. Features agree to atol 1e-4:
fp32 on both sides, summed in other orders. With a padding mask the
tower zeroes padded frames and the attention takes key lengths, a
length-0 row included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.avhubert import AVHuBERTTransformerEncoder as JaxTransformer
from avsl_tpu.models.avhubert import ConvPositionalEmbedding as JaxPosConv
from avsl_tpu.models.convert import convert_avhubert_state_dict
from avsl_tpu.models.factory import make_av_hubert_video_encoder as jax_video_encoder
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import make_av_hubert_video_encoder, state_dict_from_flax
from avsl_tpu_torch.models.avhubert import (
    AVHuBERTEncoderWrapper,
    AVHuBERTTransformerEncoder,
    ConvPositionalEmbedding,
)

AV = ("video_model", "av_hubert", "encoder")


def perturb(variables, rng):
    """Noise on every param; BatchNorm means shifted, variances 1 + |noise|."""
    noisy = lambda x, s: np.asarray(x) + s * rng.standard_normal(np.shape(x)).astype(np.float32)  # noqa: E731
    out = {"params": jax.tree_util.tree_map(lambda x: noisy(x, 0.05), variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: (np.asarray(x) + np.abs(0.5 * rng.standard_normal(np.shape(x))).astype(np.float32)
                             if path[-1].key == "var" else noisy(x, 0.2)),
            variables["batch_stats"])
    return out


def carry(variables, at=(), strip="video_model."):
    """JAX variables of a module that sits at ``AV + at`` in the Flamingo
    tree -> the port state dict of the matching module."""
    def nest(tree):
        for key in reversed(AV + at):
            tree = {key: tree}
        return tree

    sd = state_dict_from_flax(nest(variables["params"]),
                              nest(variables["batch_stats"]) if "batch_stats" in variables else None)
    return {k[len(strip):]: v for k, v in sd.items()}


def _cfgs():
    jcfg = JaxAVHuBERTConfig.tiny_test(dtype="float32", use_audio=False, modality_fuse="add")
    return jcfg, AVHuBERTConfig.tiny_test(dtype="float32", use_audio=False, modality_fuse="add")


def _padding_mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("tiny", [False, True], ids=["large", "tiny_test"])
def test_torch_avhubert_config_matches_jax(tiny):
    """The port's copy of AVHuBERTConfig: every field, default and
    tiny_test override as in the JAX package."""
    want = JaxAVHuBERTConfig.tiny_test() if tiny else JaxAVHuBERTConfig()
    got = AVHuBERTConfig.tiny_test() if tiny else AVHuBERTConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.encoder_hidden_size == want.encoder_hidden_size
    assert AVHuBERTConfig.from_dict({"conv_dim": [4, 4], "junk": 1}).conv_dim == (4, 4)


@pytest.mark.parametrize("conv_pos", [8, 5])
def test_torch_conv_positional_embedding_matches_jax(conv_pos):
    """The weight-normed grouped conv, even (drops the last step) and odd."""
    jcfg, pcfg = (dataclasses.replace(c, conv_pos=conv_pos) for c in _cfgs())
    rng = np.random.default_rng(conv_pos)
    x = rng.standard_normal((2, 11, jcfg.hidden_size)).astype(np.float32)
    jmodel = JaxPosConv(jcfg)
    variables = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    port = ConvPositionalEmbedding(pcfg)
    port.load_state_dict(carry(variables, ("transformer", "pos_conv"), "video_model.encoder.pos_conv."))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the effective kernel is flax's: scale * kernel / ||kernel|| per output channel
    p = variables["params"]
    kernel = np.asarray(p["conv"]["kernel"])
    w = np.asarray(p["WeightNorm_0"]["conv/kernel/scale"]) * kernel / np.sqrt(
        (kernel ** 2).sum(axis=(0, 1), keepdims=True))
    np.testing.assert_allclose(port[0].kernel().detach().numpy(), w.transpose(2, 1, 0),
                               rtol=1e-5, atol=1e-7)


def test_torch_pos_conv_carries_fairseq_weight_norm():
    """fairseq's weight_norm(dim=2) (a scale per tap) through the JAX
    checkpoint converter into the port gives fairseq's effective kernel."""
    _, pcfg = _cfgs()
    rng = np.random.default_rng(3)
    out, k = pcfg.hidden_size, pcfg.conv_pos
    g = rng.uniform(0.5, 2.0, (1, 1, k)).astype(np.float32)
    v = rng.standard_normal((out, out // pcfg.conv_pos_groups, k)).astype(np.float32)
    flat = convert_avhubert_state_dict({"encoder.pos_conv.0.weight_g": g,
                                        "encoder.pos_conv.0.weight_v": v,
                                        "encoder.pos_conv.0.bias": np.zeros(out, np.float32)})
    params = {key.replace("params/avhubert/encoder/", "/".join(AV) + "/"): val
              for key, val in flat.items()}
    port = ConvPositionalEmbedding(pcfg)
    port.load_state_dict({key[len("video_model.encoder.pos_conv."):]: val
                          for key, val in state_dict_from_flax(params).items()})
    want = v * g / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    np.testing.assert_allclose(port[0].kernel().detach().numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module", params=[True, False], ids=["pre_norm", "post_norm"])
def transformer(request):
    """The tower's transformer, pre-norm (fairseq's layer_norm_first, the
    AV-HuBERT large setting) and post-norm (the norm before the stack)."""
    jcfg, pcfg = (dataclasses.replace(c, layer_norm_first=request.param) for c in _cfgs())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, jcfg.hidden_size)).astype(np.float32)
    jmodel = JaxTransformer(jcfg)
    variables = perturb(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    port = AVHuBERTTransformerEncoder(pcfg)
    port.load_state_dict(carry(variables, ("transformer",), "video_model.encoder."))
    return jmodel, variables, port.eval(), x


@pytest.mark.parametrize("lengths", [None, [9, 4, 0]], ids=["no_mask", "lengths_9_4_0"])
def test_torch_avhubert_transformer_matches_jax(transformer, lengths):
    jmodel, variables, port, x = transformer
    mask = None if lengths is None else _padding_mask(lengths, x.shape[1])
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   None if mask is None else jnp.asarray(mask)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_torch_avhubert_transformer_output_layer_matches_jax(transformer):
    """fairseq's output_layer tap: the first block's output, no final norm."""
    jmodel, variables, port, x = transformer
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), output_layer=1))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), output_layer=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def video_encoder():
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(2)
    video = rng.standard_normal((3, 7, 48, 48, 1)).astype(np.float32)
    jmodel = jax_video_encoder(jcfg)
    variables = perturb(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(video)), rng)
    port = make_av_hubert_video_encoder(pcfg)
    port.load_state_dict(carry({"params": variables["params"]["av_hubert"]["encoder"],
                                "batch_stats": variables["batch_stats"]["av_hubert"]["encoder"]}))
    return jmodel, variables, port.eval(), video


@pytest.mark.parametrize("lengths", [None, [7, 3, 0]], ids=["no_mask", "lengths_7_3_0"])
def test_torch_avhubert_video_encoder_matches_jax(video_encoder, lengths):
    """Lip clip -> ResNet -> proj -> fuse_ln -> post_extract_proj ->
    pos_conv -> blocks -> final norm, end to end."""
    jmodel, variables, port, video = video_encoder
    mask = None if lengths is None else _padding_mask(lengths, video.shape[1])
    want = np.asarray(jmodel.apply(variables, jnp.asarray(video),
                                   mask=None if mask is None else jnp.asarray(mask)))
    with torch.inference_mode():
        got = port(video=torch.from_numpy(video),
                   padding_mask=None if mask is None else torch.from_numpy(mask)).numpy()
        extracted = port.extract_features(video=torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (3, 7, 32)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if lengths is None:
        np.testing.assert_array_equal(extracted, got)


def test_torch_avhubert_names_are_fairseq(video_encoder):
    """The port's state dict is a fairseq AV-HuBERT state dict: the JAX
    package's own fairseq converter maps it onto the JAX tower's variables
    (the positional conv passed as its fused kernel, which that converter
    re-parametrises)."""
    _, variables, port, _ = video_encoder
    sd = {k: t.detach().numpy() for k, t in port.state_dict().items()
          if not k.startswith("encoder.pos_conv.0.weight_")}
    sd["encoder.pos_conv.0.weight"] = port.encoder.pos_conv[0].kernel().detach().numpy()
    back = convert_avhubert_state_dict(sd)
    want = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[collection]["av_hubert"])[0]:
            key = "/".join(str(p.key) for p in path)
            want[f"{collection}/avhubert/{key}"] = np.asarray(leaf)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        if "/pos_conv/" not in key:
            np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_torch_avhubert_refuses_what_is_not_ported(video_encoder):
    _, _, port, video = video_encoder
    clip = torch.from_numpy(video)
    # a video-only tower ignores audio, as the JAX wrapper does
    with torch.inference_mode():
        assert torch.equal(port(audio=torch.zeros(3, 7, 104), video=clip), port(video=clip))
    # the MoE FFN is ported (models/moe.py): each block's MLP is the MoE
    moe = AVHuBERTEncoderWrapper(AVHuBERTConfig.tiny_test(n_experts=2))
    assert all(type(layer.mlp).__name__ == "MoEFFN" for layer in moe.encoder.layers)
    # the training draws follow the module's mode; an explicit flag must agree
    with pytest.raises(ValueError, match="deterministic=False in eval mode"):
        port(video=clip, deterministic=False)
    # span masking is ported: in training apply_time_mask draws a mask
    port.train()
    try:
        with torch.no_grad():
            masked = port(video=clip, apply_time_mask=True, use_running_average=True,
                          generator=torch.Generator().manual_seed(0))
            plain = port(video=clip, use_running_average=True,
                         generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(masked).all()) and not torch.equal(masked, plain)
    finally:
        port.eval()
