"""Port Whisper against the JAX model on carried weights (CPU, fp32).

The JAX ``tiny_test`` model is initialised, its params are perturbed with
seeded noise (so zero-initialised biases and unit norm scales carry real
values), and the same numbers go to the port through
``whisper_state_dict_from_flax``. Logits agree to atol 1e-4: fp32 on both
sides, summed in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import WhisperConfig as JaxWhisperConfig
from avsl_tpu.models import Whisper as JaxWhisper
from avsl_tpu.models.convert import convert_whisper_state_dict, rename_whisper_key
from avsl_tpu_torch.core.config import WhisperConfig
from avsl_tpu_torch.models import Whisper, build_whisper_flamingo, whisper_state_dict_from_flax
from avsl_tpu_torch.models.convert import _flatten

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


def test_torch_factory_refuses_gated_x_attn():
    with pytest.raises(NotImplementedError, match="slice 2"):
        build_whisper_flamingo("test", add_gated_x_attn=1, device="cpu")
