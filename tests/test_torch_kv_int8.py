"""The int8 decode cache (``models/quant.py::quantize_kv_cache`` and the
int8 cross cache of ``models/layers.py``) against the JAX package on the
CPU.

The port holds its caches head-major ([B,H,T,D]); JAX holds [B,T,H,D].
Quantized per row over D, the two give the same rows: q and scale
bit-equal after the transpose, and only the static cross and "xv" entries
are compressed. On the tiny Whisper-Flamingo model with carried weights,
cached decode steps over the int8 cache (alone, and with int8 weights)
give JAX's logits within 1e-5 relative and greedy decoding JAX's tokens;
beam search tiles and gathers the int8 entries; and the transcriber with
``kv_int8`` (and with ``quantize="int8"`` too) gives the JAX
transcriber's results.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avsl_tpu.decode import greedy_decode_scored as jax_greedy_scored
from avsl_tpu.models import quant as jq
from avsl_tpu_torch.decode.beam import _gather_beams, _tile_beams
from avsl_tpu_torch.decode.greedy import greedy_decode_scored
from avsl_tpu_torch.models import quant
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import (
    assert_same_results,
    carried_models,
    items,
    strict_bf16,
    transcriber_pair,
)

REL_TOL = 1e-5
MAX_NEW = 6


@pytest.fixture(scope="module")
def av():
    """(jax model, variables, port fp32 model) and seeded encoder inputs."""
    models = carried_models(av=True, seed=8, logit_scale=4.0)
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(2, 80, 100)).astype(np.float32)
    video = rng.normal(size=(2, 5, 88, 88, 1)).astype(np.float32)
    return models, mel, video


def _caches(jmodel, v, mel, video, max_len):
    """JAX's float decode cache from JAX's encoders, and the same numbers
    in the port's head-major layout: the int8 paths then start from equal
    K/V (the two encoders differ in the last bits, which can move an int8
    rounding)."""
    feats, xv = jax.jit(lambda v, m, vid: jmodel.apply(v, m, vid, method=jmodel.encode))(
        v, mel, video)
    jcache = jmodel.apply(v, feats, xv, max_len, method=jmodel.init_decode_cache)
    head_major = lambda x: torch.from_numpy(np.asarray(x).transpose(0, 2, 1, 3).copy())  # noqa
    pcache = [{name: ({"k": head_major(sub["k"]), "v": head_major(sub["v"]), "index": 0}
                      if name == "self" else {"k": head_major(sub["k"]), "v": head_major(sub["v"])})
               for name, sub in entry.items()} for entry in jcache]
    return jcache, pcache


def test_torch_quantize_kv_cache_bit_equal_head_major(av):
    (jmodel, variables, port), mel, video = av
    jcache, pcache = _caches(jmodel, variables, mel, video, 10)
    want, got = jq.quantize_kv_cache(jcache), quant.quantize_kv_cache(pcache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["cross", "self", "xv"]
        assert not isinstance(g["self"]["k"], quant.QTensor) and g["self"]["index"] == 0
        for name in ("cross", "xv"):
            for kv in ("k", "v"):
                gq, wq = g[name][kv], w[name][kv]
                assert isinstance(gq, quant.QTensor) and gq.q.dtype == torch.int8
                np.testing.assert_array_equal(gq.q.numpy(),
                                              np.asarray(wq.q).transpose(0, 2, 1, 3))
                np.testing.assert_array_equal(gq.scale.numpy(),
                                              np.asarray(wq.scale).transpose(0, 2, 1, 3))
    again = quant.quantize_kv_cache(got)  # idempotent
    assert again[0]["cross"]["k"] is got[0]["cross"]["k"]
    # the port's own cache has the same entries, the static ones compressed
    with torch.no_grad():
        own = quant.quantize_kv_cache(port.init_decode_cache(
            *port.encode(torch.from_numpy(mel), torch.from_numpy(video)), 10))
    assert [sorted(e) for e in own] == [sorted(e) for e in got]
    assert all(isinstance(e["xv"]["v"], quant.QTensor) for e in own)


def _steps(step, cache, toks):
    """Logits of the prompt step and then one token at a time."""
    out = []
    logits, cache = step(toks[:, :3], cache)
    out.append(logits)
    for i in range(3, toks.shape[1]):
        logits, cache = step(toks[:, i:i + 1], cache)
        out.append(logits)
    return out


@pytest.mark.parametrize("weights_int8", [False, True])
def test_torch_kv_int8_decode_matches_jax(av, weights_int8):
    (jmodel, variables, port), mel, video = av
    jv = jq.dequantize_tree(jq.quantize_tree(variables)) if weights_int8 else variables
    model = quant.quantize_model(port) if weights_int8 else port
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 7))
    jstep = jax.jit(lambda tok, c: jmodel.apply(jv, tok, None, None, c, method=jmodel.decode))

    def pstep(tok, c):
        return model.decode(tok, None, None, c)

    def fresh():
        jcache, pcache = _caches(jmodel, jv, mel, video, 12)
        return jq.quantize_kv_cache(jcache), quant.quantize_kv_cache(pcache)

    jcache, pcache = fresh()
    want = _steps(jstep, jcache, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = _steps(pstep, pcache, torch.from_numpy(toks))
        float_logits = _steps(pstep, _caches(jmodel, jv, mel, video, 12)[1],
                              torch.from_numpy(toks))
    for g, w in zip(got, want):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < REL_TOL
    assert any(not torch.equal(g, f) for g, f in zip(got, float_logits))  # int8 rows read

    prompt = np.tile(np.asarray([[257, 3, 4]]), (2, 1))
    jcache, pcache = fresh()
    jt, js = jax_greedy_scored(jstep, jcache, jnp.asarray(prompt, jnp.int32), MAX_NEW, 256)
    with torch.no_grad():
        pt, ps = greedy_decode_scored(pstep, pcache, torch.from_numpy(prompt), MAX_NEW, 256)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)


def test_torch_beam_cache_ops_handle_qtensor_entries():
    qt = quant.quantize_rows(torch.from_numpy(
        np.random.default_rng(1).normal(size=(2, 2, 4, 8)).astype(np.float32)))
    cache = [{"cross": {"k": qt, "v": qt}, "self": {"k": torch.zeros(2, 2, 5, 8),
                                                   "v": torch.zeros(2, 2, 5, 8), "index": 3}}]
    tiled = _tile_beams(cache, 3)
    tk = tiled[0]["cross"]["k"]
    assert isinstance(tk, quant.QTensor) and tk.q.shape[0] == 6 and tk.scale.shape[0] == 6
    assert tiled[0]["self"]["index"] == 3
    gk = _gather_beams(tiled, torch.tensor([0, 3]))[0]["cross"]["k"]
    assert torch.equal(gk.q, qt.q) and torch.equal(gk.scale, qt.scale)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_torch_kv_int8_transcriber_matches_jax(av, quantize):
    models = av[0]
    jtr, ptr = transcriber_pair(models, kv_int8=True, quantize=quantize, batch_size=2,
                                max_new_tokens=MAX_NEW)
    strict_bf16(jtr)
    batch = items(3, seed=9)
    batch[1]["lip_feats"] = np.random.default_rng(2).normal(size=(25, 88, 88, 1)).astype(
        np.float32)
    assert_same_results(jtr.transcribe(batch), ptr.transcribe(batch))
    assert ptr.kv_int8 and ptr.quantize == quantize


def test_torch_kv_int8_beam_transcriber_matches_jax(av):
    jtr, ptr = transcriber_pair(av[0], kv_int8=True, beam_size=2, batch_size=2,
                                max_new_tokens=MAX_NEW)
    batch = items(2, seed=11)
    assert_same_results(jtr.transcribe(batch), ptr.transcribe(batch))
