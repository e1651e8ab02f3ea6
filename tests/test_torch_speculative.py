"""Speculative greedy decoding (``avsl_tpu_torch/decode/speculative.py``)
and the vector-index self cache (``models/layers.py``) against
``avsl_tpu/decode/speculative.py`` on the CPU.

The cases of ``tests/test_speculative.py`` that need no mesh, on the same
tiny Whisper models (a 2-layer target, a 1-layer narrower draft) with
their weights carried into the port: with an independent draft and with
the target as its own draft, the tokens, ``accept_rate`` and ``rounds``
equal JAX's and the tokens equal plain greedy's; ``avg_logprob`` is within
1e-5 of greedy-scored's; it composes with the int8 cross cache; the
[B]-index path equals the scalar one; writes at or past the buffer's end
are dropped as JAX's scatter drops them (a clamp would overwrite the last
row); a cache too small raises; and a property sweep over the prompt
length, k = 1 and max_new < k holds against greedy decoding. The serving
side (the transcriber, the CLIs, ``/stats``, AV-HuBERT) is in
``test_torch_speculative_serving.py``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from avsl_tpu.core.config import WhisperConfig as JaxWhisperConfig
from avsl_tpu.decode.speculative import speculative_greedy_decode as jax_spec
from avsl_tpu.models import Whisper as JaxWhisper
from avsl_tpu.models.quant import quantize_kv_cache as jax_quantize_kv_cache
from avsl_tpu_torch.core.config import WhisperConfig
from avsl_tpu_torch.decode.greedy import greedy_decode, greedy_decode_scored
from avsl_tpu_torch.decode.speculative import (
    _cache_max_len,
    broadcast_cache_index,
    set_cache_index,
    speculative_greedy_decode,
)
from avsl_tpu_torch.models import Whisper, whisper_state_dict_from_flax
from avsl_tpu_torch.models.quant import quantize_kv_cache
from test_torch_flamingo_common import one_torch_thread  # noqa: F401

B = 3


def _pair(seed, n_layer=2, n_state=64, n_head=2):
    """(jax model, variables, port model, mel): a tiny Whisper with the
    JAX test's widths, its weights carried into the port."""
    kw = dict(dtype="float32", n_text_layer=n_layer, n_text_state=n_state, n_text_head=n_head,
              n_audio_layer=1, n_audio_state=n_state, n_audio_head=n_head)
    jcfg = JaxWhisperConfig.tiny_test(**kw)
    jmodel = JaxWhisper(jcfg)
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(B, jcfg.n_mels, 64)).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), mel,
                                     np.asarray([[1, 2]] * B, np.int32))
    port = Whisper(WhisperConfig.tiny_test(**kw), device="meta").materialize("cpu")
    port.load_state_dict(whisper_state_dict_from_flax(variables["params"],
                                                      n_audio_ctx=jcfg.n_audio_ctx))
    return jmodel, variables, port.eval(), mel


@pytest.fixture(scope="module")
def models():
    """Target and draft, each as (jax model, variables, port, mel), with
    each one's audio features in both packages."""
    out = []
    for args in ((0,), (7, 1, 32)):
        jmodel, variables, port, mel = _pair(*args)
        jfeats, _ = jax.jit(lambda v, m: jmodel.apply(v, m, None, method=jmodel.encode))(
            variables, mel)
        with torch.no_grad():
            pfeats, _ = port.encode(torch.from_numpy(mel))
        out.append((jmodel, variables, port, jfeats, pfeats))
    return out


class Side:
    """One package's step functions and fresh caches for target and draft."""

    def __init__(self, models, jax_side: bool, kv_int8=False):
        self.jax = jax_side
        self.steps, self.makers = [], []
        for i, (jmodel, variables, port, jfeats, pfeats) in enumerate(models):
            if jax_side:
                self.steps.append(jax.jit(
                    lambda tok, c, m=jmodel, v=variables: m.apply(v, tok, None, None, c,
                                                                  method=m.decode)))
                make = (lambda n, m=jmodel, v=variables, f=jfeats: m.apply(
                    v, f, None, n, method=m.init_decode_cache))
                comp = jax_quantize_kv_cache
            else:
                self.steps.append(lambda tok, c, m=port: m.decode(tok, None, None, c))
                make = (lambda n, m=port, f=pfeats: m.init_decode_cache(f, None, n))
                comp = quantize_kv_cache
            if kv_int8 and i == 0:
                make = (lambda n, mk=make, comp=comp: comp(mk(n)))
            self.makers.append(make)

    def prompt(self, p=2):
        toks = np.tile(np.arange(1, p + 1)[None], (B, 1))
        return jnp.asarray(toks, jnp.int32) if self.jax else torch.from_numpy(toks)

    def spec(self, max_new, k, p=2, self_draft=False, eot=255):
        need = p + max_new + k
        d = 0 if self_draft else 1
        args = (self.steps[0], self.steps[d], self.makers[0](need), self.makers[d](need),
                self.prompt(p), max_new, eot)
        if self.jax:
            return jax.jit(lambda tc, dc: jax_spec(args[0], args[1], tc, dc, *args[4:], k=k))(
                args[2], args[3])
        with torch.no_grad():
            return speculative_greedy_decode(*args, k=k)

    def greedy(self, max_new, p=2, eot=255):
        with torch.no_grad():
            return greedy_decode_scored(self.steps[0], self.makers[0](p + max_new + 2),
                                        self.prompt(p), max_new, eot)


def _same_as_jax(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert float(got.accept_rate) == float(want.accept_rate)
    assert got.rounds == int(want.rounds)
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(want.avg_logprob), atol=1e-5)


@pytest.mark.parametrize("self_draft,k", [(False, 4), (True, 3)])
def test_torch_spec_matches_jax_and_greedy(models, self_draft, k):
    max_new = 12
    port, jx = Side(models, False), Side(models, True)
    got = port.spec(max_new, k, self_draft=self_draft)
    _same_as_jax(got, jx.spec(max_new, k, self_draft=self_draft))
    ref_tokens, ref_scores = port.greedy(max_new)
    np.testing.assert_array_equal(got.tokens.numpy(), ref_tokens.numpy())
    np.testing.assert_allclose(got.avg_logprob.numpy(), ref_scores.numpy(), atol=1e-5)
    if self_draft:
        # every draft the budget admits is accepted; each round commits k + 1
        assert float(got.accept_rate) == 1.0
        assert (ref_tokens != 255).all() and got.rounds == math.ceil(max_new / (k + 1))
    else:
        assert float(got.accept_rate) < 1.0  # a random draft is no oracle


def test_torch_spec_composes_with_kv_int8(models):
    max_new, k = 8, 2
    port, jx = Side(models, False, kv_int8=True), Side(models, True, kv_int8=True)
    got = port.spec(max_new, k)
    _same_as_jax(got, jx.spec(max_new, k))
    with torch.no_grad():
        ref = greedy_decode(port.steps[0], port.makers[0](16), port.prompt(), max_new, 255)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.numpy())


def test_torch_vector_cache_index_matches_scalar(models):
    jmodel, variables, port, _, feats = models[0]
    toks = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    with torch.no_grad():
        cache_s = port.init_decode_cache(feats, None, 16)
        cache_v = broadcast_cache_index(port.init_decode_cache(feats, None, 16), B)
        lg_s, cs = port.decode(toks, None, None, cache_s)
        lg_v, cv = port.decode(toks, None, None, cache_v)
        np.testing.assert_allclose(lg_v.numpy(), lg_s.numpy(), atol=1e-6)
        tok2 = torch.tensor([[0], [1], [2]])
        lg_s2, _ = port.decode(tok2, None, None, cs)
        lg_v2, _ = port.decode(tok2, None, None, cv)
    np.testing.assert_allclose(lg_v2.numpy(), lg_s2.numpy(), atol=1e-6)
    assert cv[0]["self"]["index"].tolist() == [3, 3, 3] and cs[0]["self"]["index"] == 3
    assert _cache_max_len(cv) == 16
    reset = set_cache_index(cv, torch.tensor([1, 2, 0]))
    assert reset[0]["self"]["index"].tolist() == [1, 2, 0]
    assert reset[1]["cross"]["k"] is cv[1]["cross"]["k"]


def test_torch_vector_index_drops_writes_past_the_buffer(models):
    """Per-sequence offsets 3, 4 and 5 into a 5-row buffer, 2 tokens each:
    row 3 and 4, row 4 only, and nothing are written (JAX's ``mode="drop"``;
    a clamped write would put the second token over row 4). The buffers
    and the logits equal JAX's."""
    jmodel, variables, port, jfeats, pfeats = models[0]
    toks = np.asarray([[5, 6], [7, 8], [9, 10]])
    index = np.asarray([3, 4, 5])
    jcache = jmodel.apply(variables, jfeats, None, 5, method=jmodel.init_decode_cache)
    rng = np.random.default_rng(0)
    fill = [rng.normal(size=np.shape(e["self"]["k"])).astype(np.float32) for e in jcache]
    jcache = [{**e, "self": {"k": jnp.asarray(f), "v": jnp.asarray(-f),
                             "index": jnp.asarray(index, jnp.int32)}}
              for e, f in zip(jcache, fill)]
    jlogits, jout = jmodel.apply(variables, jnp.asarray(toks, jnp.int32), None, None, jcache,
                                 method=jmodel.decode)
    with torch.no_grad():
        pcache = port.init_decode_cache(pfeats, None, 5)
        for e, f in zip(pcache, fill):
            e["self"]["k"].copy_(torch.from_numpy(f.transpose(0, 2, 1, 3)))
            e["self"]["v"].copy_(torch.from_numpy(-f.transpose(0, 2, 1, 3)))
            e["self"]["index"] = torch.from_numpy(index)
        plogits, pout = port.decode(torch.from_numpy(toks), None, None, pcache)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=1e-5)
    for p, j, f in zip(pout, jout, fill):
        k = p["self"]["k"].numpy()
        np.testing.assert_allclose(k, np.asarray(j["self"]["k"]).transpose(0, 2, 1, 3),
                                   atol=1e-5)
        head_major = f.transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(k[1, :, :4], head_major[1, :, :4])  # row 4 only
        np.testing.assert_array_equal(k[2], head_major[2])  # nothing written
        assert not np.array_equal(k[0, :, 3:5], head_major[0, :, 3:5])
        assert p["self"]["index"].tolist() == [5, 6, 7]


def test_torch_spec_refuses_a_cache_too_small_and_bad_arguments(models):
    port = Side(models, False)
    args = (port.steps[0], port.steps[1], port.makers[0](2 + 20 + 4),
            port.makers[1](2 + 20 + 4))
    with pytest.raises(ValueError, match="max_len 26 < prompt"):
        speculative_greedy_decode(*args, port.prompt(), 40, 255, k=4)
    with pytest.raises(ValueError, match="k must be >= 1"):
        speculative_greedy_decode(*args, port.prompt(), 4, 255, k=0)
    with pytest.raises(ValueError, match="prompt of >= 2"):
        speculative_greedy_decode(*args, port.prompt()[:, :1], 4, 255, k=2)


@pytest.mark.parametrize("p,max_new,k", [(2, 1, 1), (2, 5, 2), (3, 2, 4), (4, 6, 1), (5, 7, 3)])
def test_torch_spec_edge_cases_match_jax(models, p, max_new, k):
    """JAX's sweep: minimal everything, max_new < k, k = 1 (no draft loop),
    a prompt long enough to warm the draft."""
    port, jx = Side(models, False), Side(models, True)
    got = port.spec(max_new, k, p=p)
    _same_as_jax(got, jx.spec(max_new, k, p=p))
    ref_tokens, ref_scores = port.greedy(max_new, p=p)
    np.testing.assert_array_equal(got.tokens.numpy(), ref_tokens.numpy())
    np.testing.assert_allclose(got.avg_logprob.numpy(), ref_scores.numpy(), atol=1e-5)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(p=st.integers(2, 6), max_new=st.integers(1, 9), k=st.integers(1, 5),
       self_draft=st.booleans(), eot=st.integers(0, 255))
def test_torch_spec_property_fuzz_vs_greedy(models, p, max_new, k, self_draft, eot):
    """Token- and score-exact against greedy decoding over the prompt
    length (the draft's warm-up), k = 1, max_new < k, and an EOT id that
    the random models may or may not emit."""
    port = Side(models, False)
    got = port.spec(max_new, k, p=p, self_draft=self_draft, eot=eot)
    ref_tokens, ref_scores = port.greedy(max_new, p=p, eot=eot)
    np.testing.assert_array_equal(got.tokens.numpy(), ref_tokens.numpy())
    np.testing.assert_allclose(got.avg_logprob.numpy(), ref_scores.numpy(), atol=1e-5)
    assert 0.0 <= float(got.accept_rate) <= 1.0 and got.rounds >= 1
