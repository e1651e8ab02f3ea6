"""Shared carriers for the Flamingo-training parity tests, and the port's
dropout paths by their statistics (CPU).

The JAX tiny Whisper-Flamingo model (``add_gated_x_attn=1`` with the tiny
AV-HuBERT tower) is initialised, every param perturbed with seeded noise,
the BatchNorm statistics shifted, the gates set nonzero (zero gates would
hide the video), and the same numbers carried into the port. Training
draws cannot match JAX bit for bit, so the parity tests set every rate to
0 (``ZERO_RATES``) and hold the random paths here by their statistics
(5-sigma bounds stated where used) and their eval-mode no-ops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import AVHuBERTConfig as JaxAVHuBERTConfig
from avsl_tpu.models.factory import build_whisper_flamingo as jax_build
from avsl_tpu_torch.core.config import AVHuBERTConfig
from avsl_tpu_torch.models import build_whisper_flamingo, state_dict_from_flax
from avsl_tpu_torch.models import whisper_state_dict_from_flax
from avsl_tpu_torch.models.avhubert import AVHuBERTTransformerEncoder
from avsl_tpu_torch.models.layers import MLP, head_major_attention

# every training draw of the tower off: dropout, attention and activation
# dropout, input dropout, LayerDrop, modality dropout
ZERO_RATES = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  dropout_input=0.0, layerdrop=0.0, modality_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module of these tests runs: the
    tiny models gain nothing from more, and xdist workers that each spin
    a thread per core slow one another down many times over. Every
    Flamingo test module imports this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noisy_av_variables(variables, rng):
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


def carried_flamingo(seed: int = 0, frames: int = 6, hw: int = 48, **av_overrides):
    """(jax model, jax variables, port model, whisper cfg): the tiny fp32
    Whisper-Flamingo on the same weights, every tower rate 0 (plus
    ``av_overrides``) and Whisper dropout 0; the port model holds fp32
    weights."""
    rates = {**ZERO_RATES, **av_overrides}
    model, cfg = jax_build("test", add_gated_x_attn=1, use_av_hubert_encoder=True,
                           av_hubert_cfg=JaxAVHuBERTConfig.tiny_test(dtype="float32", **rates),
                           dtype="float32")
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32)
    toks = rng.integers(0, cfg.n_vocab, size=(2, 6)).astype(np.int32)
    video = rng.normal(size=(2, frames, hw, hw, 1)).astype(np.float32)
    init = jax.jit(lambda key, m, t, v: model.init(key, m, t, video=v))
    variables = noisy_av_variables(
        init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(toks), jnp.asarray(video)), rng)
    port, _ = build_whisper_flamingo(
        "test", add_gated_x_attn=1, use_av_hubert_encoder=True,
        av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32", **rates),
        dtype="float32", param_dtype="float32", device="cpu")
    port.load_state_dict(whisper_state_dict_from_flax(
        variables["params"], n_audio_ctx=cfg.n_audio_ctx, batch_stats=variables["batch_stats"]))
    return model, variables, port, cfg


def port_batch_stats(port):
    """The port's BatchNorm running statistics by state-dict key."""
    return {k: v.detach().clone() for k, v in port.state_dict().items() if "running_" in k}


def assert_batch_stats_close(port, jax_stats, atol):
    """The port's running statistics against JAX ``batch_stats``."""
    want = state_dict_from_flax({}, jax_stats)
    got = port_batch_stats(port)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=atol, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# the random paths by their statistics
# ---------------------------------------------------------------------------


def test_torch_attention_dropout_statistics():
    """Uniform attention weights over 64 keys read out through V = I: each
    output cell is a dropped weight, 0 or (1/64) / (1 - rate). 2^17 cells
    at rate 0.25: the dropped share within 5 sigma (0.006) of the rate."""
    b, h, k = 8, 4, 64
    q = torch.zeros(b, h, 64, 16)
    keys = torch.randn(b, h, k, 16)
    v = torch.eye(k).expand(b, h, k, k)
    gen = torch.Generator().manual_seed(0)
    out = head_major_attention(q, keys, v, dropout_rate=0.25, generator=gen)
    dropped = (out == 0).float().mean().item()
    assert abs(dropped - 0.25) < 0.006
    np.testing.assert_allclose(out[out != 0].numpy(), 1 / 64 / 0.75, rtol=1e-6)
    assert torch.equal(head_major_attention(q, keys, v), torch.full_like(out, 1 / 64))


def test_torch_activation_dropout_statistics_and_eval_noop():
    """An MLP whose fc1 and fc2 are identities with a large fc1 bias
    (GELU(x) = x there) shows its activation dropout: 2^17 cells at rate
    0.3, the dropped share within 5 sigma (0.0064)."""
    mlp = MLP(64, 64, dtype=torch.float32, dropout=0.3)
    with torch.no_grad():
        for lin in (mlp[0], mlp[2]):
            lin.weight.copy_(torch.eye(64))
            lin.bias.zero_()
        mlp[0].bias.fill_(10.0)
    x = torch.rand(2048, 64)
    with torch.no_grad():
        assert torch.allclose(mlp.eval()(x), x + 10.0)
        out = mlp.train()(x, torch.Generator().manual_seed(1))
    dropped = (out == 0).float().mean().item()
    assert abs(dropped - 0.3) < 0.0064
    np.testing.assert_allclose(out[out != 0].numpy(), ((x + 10.0) / 0.7)[out != 0].numpy(),
                               rtol=1e-5)


def test_torch_layerdrop_statistics_and_eval_noop():
    """LayerDrop 0.5 on a one-layer tower transformer (every other rate 0):
    each training forward returns the block's output (eval's) or its
    input, for the whole batch at once; over 300 forwards the dropped
    share is 0.5 within 5 sigma (0.145). Eval mode never drops."""
    cfg = AVHuBERTConfig.tiny_test(dtype="float32", **{**ZERO_RATES, "layerdrop": 0.5},
                                   num_hidden_layers=1)
    enc = AVHuBERTTransformerEncoder(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0.0, 0.2, generator=gen)
        x = torch.randn(3, 9, cfg.hidden_size, generator=gen)
        enc.eval()
        kept = enc(x, output_layer=1)
        dropped_out = x + enc.pos_conv(x)
        assert torch.equal(enc(x, output_layer=1), kept)
        enc.train()
        n_dropped = 0
        for _ in range(300):
            out = enc(x, output_layer=1, generator=gen)
            if torch.equal(out, dropped_out):
                n_dropped += 1
            else:
                torch.testing.assert_close(out, kept, atol=1e-6, rtol=0)
    assert abs(n_dropped / 300 - 0.5) < 0.145


def test_torch_tower_dropouts_are_eval_noops():
    """Every tower rate at 0.5 changes nothing in eval mode (no generator
    needed), and in training the same generator seed gives the same
    features while another seed gives others."""
    rates = dict(hidden_dropout=0.5, attention_dropout=0.5, activation_dropout=0.5,
                 dropout_input=0.5, layerdrop=0.5)
    port, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32", device="cpu",
                                     av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32",
                                                                            **rates))
    tower = port.video_model
    video = torch.randn(2, 5, 48, 48, 1)
    with torch.no_grad():
        a = tower(video=video)
        zero_rates, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                               device="cpu")
        zero_rates.load_state_dict(port.state_dict())
        assert torch.equal(a, zero_rates.video_model(video=video))
        tower.train()
        runs = [tower(video=video, use_running_average=True,
                      generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], a)
    with pytest.raises(ValueError, match="Generator"):
        tower(video=video)
