"""Port Whisper(-Flamingo) against the JAX model on carried weights (CPU, fp32).

The JAX ``tiny_test`` model is initialised, its params are perturbed with
seeded noise (so zero-initialised biases and unit norm scales carry real
values), and the same numbers go to the port through
``whisper_state_dict_from_flax``. Logits agree to atol 1e-4: fp32 on both
sides, summed in different orders.

The Flamingo model (the tiny AV-HuBERT video tower, gated ``x_attn`` and
``x_mlp`` in every decoder block, ``video_projection``) also has its
BatchNorm statistics perturbed and both gates of every block set to
nonzero values; zero gates (their initial value) would hide the video
from the logits, so each AV test first checks that the video moves them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import WhisperConfig as JaxWhisperConfig
from avsl_tpu.models import Whisper as JaxWhisper
from avsl_tpu.models.convert import convert_whisper_state_dict, rename_whisper_key
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.core.config import AVHuBERTConfig, WhisperConfig
from avsl_tpu_torch.models import (
    Whisper,
    build_whisper_flamingo,
    make_av_hubert_video_encoder,
    whisper_state_dict_from_flax,
)
from avsl_tpu_torch.models.convert import _flatten, flax_path_to_torch_key

ALL_WHISPER_SIZES = [
    "tiny", "base", "small", "medium", "large", "large-v2", "large-v3",
    "tiny.en", "base.en", "small.en", "medium.en",
]


@pytest.fixture(scope="module")
def carried():
    """(jax model, jax params, port model, mel, tokens) on the same weights."""
    cfg = JaxWhisperConfig.tiny_test(dtype="float32")
    model = JaxWhisper(cfg)
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    toks = rng.integers(0, cfg.n_vocab, size=(2, 6)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(toks))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params,
    )
    port, _ = build_whisper_flamingo("test", add_gated_x_attn=0, use_av_hubert_encoder=False,
                                     dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(params, n_audio_ctx=cfg.n_audio_ctx))
    return model, params, port, mel, toks


def test_torch_whisper_encoder_features(carried):
    model, params, port, mel, _ = carried
    want, _ = model.apply({"params": params}, jnp.asarray(mel), method=model.encode)
    with torch.inference_mode():
        got, xv = port.encode(torch.from_numpy(mel))
    assert xv is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_torch_whisper_teacher_forced_logits(carried):
    model, params, port, mel, toks = carried
    want = model.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks))
    with torch.inference_mode():
        got = port(torch.from_numpy(mel), torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_torch_whisper_cached_decode_logits(carried):
    model, params, port, mel, toks = carried
    v = {"params": params}
    prompt, nxt = toks[:, :4], toks[:, 4:5]
    feats, _ = model.apply(v, jnp.asarray(mel), method=model.encode)
    cache = model.apply(v, feats, None, 12, method=model.init_decode_cache)
    want0, cache = model.apply(v, jnp.asarray(prompt), None, None, cache, method=model.decode)
    want1, _ = model.apply(v, jnp.asarray(nxt), None, None, cache, method=model.decode)
    with torch.inference_mode():
        pf, _ = port.encode(torch.from_numpy(mel))
        pc = port.init_decode_cache(pf, None, 12)
        got0, pc = port.decode(torch.from_numpy(prompt).long(), None, None, pc)
        got1, pc = port.decode(torch.from_numpy(nxt).long(), None, None, pc)
    assert pc[0]["self"]["index"] == 5
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-4)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-4)


def test_torch_whisper_state_dict_round_trip(carried):
    _, params, port, _, _ = carried
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    back = convert_whisper_state_dict(sd)
    want = _flatten(params)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def _flax_shape(key: str, shape: tuple) -> tuple:
    path = rename_whisper_key(key)
    if path.endswith("/kernel") and len(shape) == 2:
        return path, shape[::-1]
    if path.endswith("/kernel") and len(shape) == 3:
        return path, (shape[2], shape[1], shape[0])
    return path, shape


@pytest.mark.parametrize("size", ALL_WHISPER_SIZES)
def test_torch_whisper_schema_matches_jax(size):
    """State-dict names and shapes, built on the meta device (nothing is
    allocated), against the JAX param tree from jax.eval_shape."""
    port = Whisper(WhisperConfig.from_name(size, dtype="float32"), device="meta")
    assert all(t.is_meta for t in port.state_dict().values())
    ours = dict(
        _flax_shape(k, tuple(t.shape))
        for k, t in port.state_dict().items()
        if k != "encoder.positional_embedding"
    )
    cfg = JaxWhisperConfig.from_name(size, dtype="float32")
    tree = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, cfg.n_mels, 64), jnp.float32),
        jax.ShapeDtypeStruct((1, 3), jnp.int32),
    )["params"]
    theirs = {
        "/".join(str(p.key) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    assert ours == theirs
    assert tuple(port.encoder.positional_embedding.shape) == (cfg.n_audio_ctx, cfg.n_audio_state)


def _noisy_av_variables(variables, rng):
    """Noise on every param, BatchNorm means shifted and variances 1 +
    |noise|, and the gates of block i set to 0.8 - 0.5 i (x_attn) and
    -0.6 + 0.3 i (x_mlp)."""
    def param(path, x):
        name = str(path[-1].key)
        if name in ("x_attn_gate", "x_mlp_gate"):
            i = int(str(path[-2].key).split("_")[-1])
            return np.full(np.shape(x), 0.8 - 0.5 * i if name == "x_attn_gate" else -0.6 + 0.3 * i,
                           np.float32)
        return np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)

    def stat(path, x):
        noise = rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.asarray(x) + (np.abs(0.5 * noise) if path[-1].key == "var" else 0.2 * noise)

    return {"params": jax.tree_util.tree_map_with_path(param, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


@pytest.fixture(scope="module")
def carried_av():
    """(jax model, jax variables, port model, mel, tokens, video) for the
    tiny Flamingo model on the same weights."""
    model, cfg = jax_build("test", add_gated_x_attn=1, use_av_hubert_encoder=True,
                           dtype="float32")
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    toks = rng.integers(0, cfg.n_vocab, size=(2, 6)).astype(np.int32)
    video = rng.normal(size=(2, 6, 48, 48, 1)).astype(np.float32)
    variables = _noisy_av_variables(
        model.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(toks),
                   video=jnp.asarray(video)), rng)
    port, _ = build_whisper_flamingo("test", add_gated_x_attn=1, use_av_hubert_encoder=True,
                                     dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(
        variables["params"], n_audio_ctx=cfg.n_audio_ctx, batch_stats=variables["batch_stats"]))
    return model, variables, port, mel, toks, video


def _port_logits(port, mel, toks, video, **kw):
    with torch.inference_mode():
        return port(torch.from_numpy(mel), torch.from_numpy(toks).long(),
                    None if video is None else torch.from_numpy(video), **kw).numpy()


def test_torch_flamingo_teacher_forced_logits(carried_av):
    model, variables, port, mel, toks, video = carried_av
    got = _port_logits(port, mel, toks, video)
    assert np.abs(got - _port_logits(port, mel, toks, np.zeros_like(video))).max() > 1e-2
    want = model.apply(variables, jnp.asarray(mel), jnp.asarray(toks), video=jnp.asarray(video))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_torch_flamingo_logits_with_video_mask(carried_av):
    """A padding mask zeroes padded frames and masks them as keys in the
    tower (a length-0 row included), against the JAX tower with the mask."""
    model, variables, port, mel, toks, video = carried_av
    mask = np.arange(video.shape[1])[None, :] < np.array([[4], [0]])
    got = _port_logits(port, mel, toks, video, video_mask=torch.from_numpy(mask))
    assert np.abs(got - _port_logits(port, mel, toks, video)).max() > 1e-3
    want = model.apply(variables, jnp.asarray(mel), jnp.asarray(toks), video=jnp.asarray(video),
                       video_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_torch_flamingo_video_feature_scale_zero(carried_av):
    """Scale 0 (the audio-only draw of AV-mode mixing) still runs the gated
    sublayers, on a zeroed stream, as the JAX model does."""
    model, variables, port, mel, toks, video = carried_av
    got = _port_logits(port, mel, toks, video, video_feature_scale=0.0)
    want = model.apply(variables, jnp.asarray(mel), jnp.asarray(toks), video=jnp.asarray(video),
                       video_feature_scale=0.0)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert np.abs(got - _port_logits(port, mel, toks, video)).max() > 1e-2


def test_torch_flamingo_split_matches_forward(carried_av):
    """encode_towers + project_and_decode computes forward (the hoisted
    split of the train step)."""
    _, _, port, mel, toks, video = carried_av
    with torch.inference_mode():
        feats, v = port.encode_towers(torch.from_numpy(mel), torch.from_numpy(video))
        assert v.shape == (2, 6, port.cfg.video_state)
        split = port.project_and_decode(torch.from_numpy(toks).long(), feats, v).numpy()
    np.testing.assert_allclose(split, _port_logits(port, mel, toks, video), atol=1e-6)


def test_torch_flamingo_cached_decode_with_xv(carried_av):
    """init_decode_cache with the "xv" entry, then a prompt and three
    cached single-token steps, against the JAX decode."""
    model, variables, port, mel, toks, video = carried_av
    feats, xv = model.apply(variables, jnp.asarray(mel), jnp.asarray(video), method=model.encode)
    cache = model.apply(variables, feats, xv, 12, method=model.init_decode_cache)
    want = []
    for tok in (toks[:, :3], toks[:, 3:4], toks[:, 4:5], toks[:, 5:6]):
        logits, cache = model.apply(variables, jnp.asarray(tok), None, None, cache,
                                    method=model.decode)
        want.append(np.asarray(logits))
    with torch.inference_mode():
        pf, pxv = port.encode(torch.from_numpy(mel), torch.from_numpy(video))
        np.testing.assert_allclose(pxv.numpy(), np.asarray(xv), atol=1e-4)
        pc = port.init_decode_cache(pf, pxv, 12)
        assert all(sorted(c) == ["cross", "self", "xv"] for c in pc)
        got = []
        for tok in (toks[:, :3], toks[:, 3:4], toks[:, 4:5], toks[:, 5:6]):
            logits, pc = port.decode(torch.from_numpy(tok).long(), None, None, pc)
            got.append(logits.numpy())
    assert pc[0]["self"]["index"] == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)


def _jax_tree_shapes(tree):
    return {
        "/".join(str(p.key) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _carried_shape(path: str, shape: tuple) -> tuple:
    if path.endswith("pos_conv/WeightNorm_0/conv/kernel/scale"):
        return (shape[0], 1, 1)
    if path.endswith("kernel") and len(shape) >= 2:  # [..., in, out] -> [out, in, ...]
        return (shape[-1], shape[-2], *shape[:-2])
    return shape


def test_torch_flamingo_schema_matches_jax():
    """Whisper large-v2 with the AV-HuBERT large tower: every JAX variable
    (params and batch_stats) maps to a port state-dict entry of the carried
    shape, built on the meta device, and nothing is left over."""
    port = Whisper(
        WhisperConfig.from_name("large-v2", dtype="float32", add_gated_x_attn=1),
        video_model=make_av_hubert_video_encoder(AVHuBERTConfig(dtype="float32"), device="meta"),
        device="meta",
    )
    ours = {k: tuple(t.shape) for k, t in port.state_dict().items()
            if k != "encoder.positional_embedding"}
    model, cfg = jax_build("large-v2", add_gated_x_attn=1, use_av_hubert_encoder=True,
                           dtype="float32")
    tree = jax.eval_shape(
        lambda key, mel, toks, video: model.init(key, mel, toks, video=video),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, cfg.n_mels, 64), jnp.float32),
        jax.ShapeDtypeStruct((1, 3), jnp.int32), jax.ShapeDtypeStruct((1, 5, 88, 88, 1), jnp.float32),
    )
    theirs = {}
    for collection in ("params", "batch_stats"):
        for path, shape in _jax_tree_shapes(tree[collection]).items():
            theirs[flax_path_to_torch_key(path)] = _carried_shape(path, shape)
    assert ours == theirs
    n_params = sum(int(np.prod(s)) for k, s in ours.items() if "running_" not in k)
    assert 2.4e9 < n_params < 2.6e9


def test_torch_factory_refuses_gated_x_attn():
    """add_gated_x_attn=1 now builds the Flamingo model, with zero gates at
    initialisation, the AV-HuBERT tower as its video model and every other
    block's sublayers; an MoE tower (models/moe.py) builds too."""
    port, cfg = build_whisper_flamingo("test", add_gated_x_attn=1, device="cpu")
    assert cfg.video_state == AVHuBERTConfig.tiny_test().hidden_size
    assert port.video_model.cfg.use_audio is False and port.video_model.cfg.modality_fuse == "add"
    gates = [p for n, p in port.named_parameters() if n.endswith("_gate")]
    assert len(gates) == 2 * cfg.n_text_layer and all(g.dtype == torch.float32 for g in gates)
    assert not any(bool(g.detach().any()) for g in gates)
    moe, _ = build_whisper_flamingo("test", add_gated_x_attn=1, device="cpu",
                                    av_hubert_cfg=AVHuBERTConfig.tiny_test(n_experts=2))
    routers = [p for n, p in moe.named_parameters() if n.endswith(".mlp.router")]
    assert len(routers) == AVHuBERTConfig.tiny_test().num_hidden_layers
    assert all(bool(r.detach().any()) for r in routers)
