"""The port's temperature-sampled decode (decode/greedy.py::
sampled_decode_scored) against the JAX package's (CPU).

With JAX's Gumbel draws injected in JAX's key order (``k0`` for the first
step, then ``split(rng, max_new_tokens - 1)`` by step), the sampled
tokens are equal and the mean log-probability within 1e-4, on a logits
table with and without a biasing trie and on the tiny model's cached
decode. Near T = 0 the sampled decode is the greedy decode; the noise
comes from the generator it is given, and the same seed repeats it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.decode import biasing as jax_biasing
from avsl_tpu.decode import greedy as jax_greedy
from avsl_tpu.kernels import log_mel_spectrogram as jax_log_mel
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode import biasing, greedy
from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import carried_models, patch_jax_noise

V, EOT = 13, 0
PROMPT = np.asarray([ByteTokenizer().sot_sequence("en")] * 3, np.int64)


def _table_step(table, xp):
    """step_fn over a logits table [steps, B, V]; the cache is the step."""
    def step(tok, idx):
        logits = table[idx][:, None, :]
        if xp is torch:
            return logits.expand(-1, tok.shape[1], -1), idx + 1
        return jnp.broadcast_to(logits, (logits.shape[0], tok.shape[1], logits.shape[2])), idx + 1
    return step


@pytest.mark.parametrize("temperature", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("boost", [False, True])
def test_torch_sampled_table_matches_jax(monkeypatch, temperature, boost):
    rng = np.random.default_rng(int(temperature * 10) + boost)
    steps, b, max_new = 10, 4, 9
    table = (2.0 * rng.normal(size=(steps, b, V))).astype(np.float32)
    table[5:, :, EOT] += 1.5  # rows finish at different steps
    key = jax.random.PRNGKey(7)
    tries = (None, None)
    if boost:
        tries = (jax_biasing.build_biasing_trie([[3, 4], [5]], V, 2.0),
                 biasing.build_biasing_trie([[3, 4], [5]], V, 2.0))
    want = jax_greedy.sampled_decode_scored(
        _table_step(jnp.asarray(table), jnp), 0, jnp.zeros((b, 2), jnp.int32), max_new, EOT,
        temperature, key, biasing=tries[0])
    patch_jax_noise(monkeypatch, max_new, key=key)
    got = greedy.sampled_decode_scored(
        _table_step(torch.from_numpy(table), torch), 0, torch.zeros((b, 2), dtype=torch.int64),
        max_new, EOT, temperature, torch.Generator(), biasing=tries[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    greedy_tokens = greedy.greedy_decode(_table_step(torch.from_numpy(table), torch), 0,
                                         torch.zeros((b, 2), dtype=torch.int64), max_new, EOT)
    if temperature >= 1.0:  # not vacuous: sampling left the greedy path
        assert not torch.equal(got[0], greedy_tokens)


@pytest.fixture(scope="module")
def av_models():
    return carried_models(av=True, seed=13)


def _port_cache(port, audio, video):
    """The port's decode step and a fresh cache of the tiny AV model."""
    with torch.inference_mode():
        mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=port.cfg.n_mels)
        feats, xv = port.encode(mel, torch.from_numpy(video))
        cache = port.init_decode_cache(feats, xv, 16)
    return (lambda tok, c: port.decode(tok, None, None, c)), cache


def _caches(models, audio, video):
    """The JAX and port decode steps and caches of the tiny AV model for
    one batch."""
    jmodel, variables, port = models
    mel = jax_log_mel(jnp.asarray(audio), n_mels=jmodel.cfg.n_mels)
    feats, xv = jmodel.apply(variables, mel, jnp.asarray(video), method=jmodel.encode)
    jcache = jmodel.apply(variables, feats, xv, 16, method=jmodel.init_decode_cache)

    def jstep(tok, c):
        return jmodel.apply(variables, tok, None, None, c, method=jmodel.decode)

    return (jstep, jcache), _port_cache(port, audio, video)


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_torch_sampled_tiny_model_matches_jax(monkeypatch, av_models, temperature):
    rng = np.random.default_rng(3)
    audio = (0.2 * rng.standard_normal((3, 16000))).astype(np.float32)
    video = rng.normal(size=(3, 25, 88, 88, 1)).astype(np.float32)
    (jstep, jcache), (pstep, pcache) = _caches(av_models, audio, video)
    key, max_new, eot = jax.random.PRNGKey(11), 10, ByteTokenizer().eot
    want = jax_greedy.sampled_decode_scored(jstep, jcache, jnp.asarray(PROMPT, jnp.int32),
                                            max_new, eot, temperature, key)
    patch_jax_noise(monkeypatch, max_new, key=key)
    with torch.inference_mode():
        got = greedy.sampled_decode_scored(pstep, pcache, torch.from_numpy(PROMPT), max_new,
                                           eot, temperature, torch.Generator())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)


def test_torch_sampled_near_zero_temperature_is_greedy(av_models):
    rng = np.random.default_rng(4)
    audio = (0.2 * rng.standard_normal((3, 16000))).astype(np.float32)
    video = rng.normal(size=(3, 25, 88, 88, 1)).astype(np.float32)
    prompt, eot = torch.from_numpy(PROMPT), ByteTokenizer().eot
    outs = []
    for kind in ("greedy", "sampled", "sampled", "sampled_t1"):
        pstep, cache = _port_cache(av_models[2], audio, video)
        gen = torch.Generator()
        gen.manual_seed(5)
        with torch.inference_mode():
            if kind == "greedy":
                outs.append(greedy.greedy_decode_scored(pstep, cache, prompt, 10, eot))
            else:
                t = 1e-8 if kind == "sampled" else 1.0
                outs.append(greedy.sampled_decode_scored(pstep, cache, prompt, 10, eot, t, gen))
    for got in outs[1:3]:
        assert torch.equal(got[0], outs[0][0])
        torch.testing.assert_close(got[1], outs[0][1], rtol=0, atol=0)
    assert not torch.equal(outs[3][0], outs[0][0])  # T = 1 samples off the greedy path


def test_torch_gumbel_noise_uses_its_generator():
    gens = [torch.Generator(), torch.Generator()]
    for g in gens:
        g.manual_seed(9)
    state = torch.random.get_rng_state()
    a, b = (greedy.gumbel_noise(g, (4, 1000), "cpu") for g in gens)
    assert torch.equal(torch.random.get_rng_state(), state)  # the global RNG is untouched
    assert torch.equal(a, b) and torch.isfinite(a).all()
    # standard Gumbel: mean is Euler's constant, variance pi^2 / 6 (5 sigma)
    assert abs(a.mean().item() - 0.5772) < 5 * (np.pi / np.sqrt(6)) / np.sqrt(a.numel())
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.15
