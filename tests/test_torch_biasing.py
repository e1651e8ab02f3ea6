"""Contextual biasing of the port (decode/biasing.py) against the JAX
package (CPU).

The trie's tables are bit-equal to JAX's; ``bias_adjust`` and
``bias_advance`` agree on every state and token; the JAX tests' cases
(tests/test_biasing.py: the argmax flip, the true score, the banked
nested phrase, the full refund, the abandoned beam prefix) run through
both decoders with equal tokens and scores within 1e-5; and the tiny
model's transcriber with ``boost_phrases`` gives JAX's tokens, greedy and
beam, with scores within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avsl_tpu.decode import beam as jax_beam
from avsl_tpu.decode import biasing as jax_biasing
from avsl_tpu.decode import greedy as jax_greedy
from avsl_tpu_torch.data.tokenizer import ByteTokenizer
from avsl_tpu_torch.decode import beam, biasing, greedy
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import carried_models, items, transcriber_pair

V, EOT = 12, 0
PHRASE_SETS = [
    [[3, 4, 5], [3, 7]],
    [[3], [3, 4, 5]],
    [[3, 4, 5]],
    [[11, 10, 9], [2], [2, 6, 6, 1], [9, 9]],
]


def _tries(phrases, weight=2.0, vocab=V):
    return (jax_biasing.build_biasing_trie(phrases, vocab, weight=weight),
            biasing.build_biasing_trie(phrases, vocab, weight=weight))


@pytest.mark.parametrize("phrases", PHRASE_SETS, ids=lambda p: str(len(p)))
def test_torch_trie_tables_bit_equal(phrases):
    jt, pt = _tries(phrases, weight=1.75)
    for name in ("next_node", "bonus", "reset", "banked", "depth"):
        want, got = np.asarray(getattr(jt, name)), getattr(pt, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pt.n_nodes == jt.n_nodes
    assert pt.nbytes == sum(np.asarray(getattr(jt, n)).nbytes
                            for n in ("next_node", "bonus", "reset", "banked", "depth"))


@pytest.mark.parametrize("phrases", PHRASE_SETS, ids=lambda p: str(len(p)))
def test_torch_bias_adjust_and_advance_match_jax(phrases):
    jt, pt = _tries(phrases)
    states = np.arange(pt.n_nodes)
    np.testing.assert_array_equal(
        biasing.bias_adjust(pt, torch.from_numpy(states)).numpy(),
        np.asarray(jax_biasing.bias_adjust(jt, jnp.asarray(states))))
    for tok in range(V):
        toks = np.full_like(states, tok)
        np.testing.assert_array_equal(
            biasing.bias_advance(pt, torch.from_numpy(states), torch.from_numpy(toks)).numpy(),
            np.asarray(jax_biasing.bias_advance(jt, jnp.asarray(states), jnp.asarray(toks))))


def test_torch_trie_validation():
    for bad in (([], {}), ([[3, V + 1]], {}), ([[3]], {"weight": 0.0})):
        with pytest.raises(ValueError):
            biasing.build_biasing_trie(bad[0], V, **bad[1])
    with pytest.raises(ValueError):
        biasing.encode_phrases(ByteTokenizer(), ["  ", ""])
    assert biasing.encode_phrases(ByteTokenizer(), [" ab "]) == [[97, 98], [32, 97, 98]]


@pytest.mark.parametrize("phrases,walk", [
    ([[3], [3, 4, 5]], (3, 4, 9)),  # [3] stays banked: net +w
    ([[3, 4, 5]], (3, 4, 9)),  # no completed end: refunded to 0
    ([[3], [3, 4, 5]], (3, 3, 4, 5, EOT)),
    ([[3, 4, 5], [3, 7]], (3, 7, 3, 4, EOT)),
])
def test_torch_biasing_walks_match_jax(phrases, walk):
    """The JAX tests' refund cases: the summed boost along a walk and every
    state on it agree."""
    jt, pt = _tries(phrases)
    totals, js, ps = [0.0, 0.0], jnp.asarray([0]), torch.tensor([0])
    for tok in walk:
        totals[0] += float(np.asarray(jax_biasing.bias_adjust(jt, js))[0][tok])
        totals[1] += float(biasing.bias_adjust(pt, ps)[0, tok])
        js = jax_biasing.bias_advance(jt, js, jnp.asarray([tok]))
        ps = biasing.bias_advance(pt, ps, torch.tensor([tok]))
        assert int(ps[0]) == int(js[0])
    assert totals[1] == totals[0]


def _const_step(rows, xp):
    """step_fn emitting fixed logits per decode position; the cache is the
    position."""
    rows = xp.asarray(rows) if xp is jnp else torch.from_numpy(np.asarray(rows))

    def step(tok, i):
        row = rows[min(int(i), rows.shape[0] - 1)] if xp is torch else \
            rows[jnp.minimum(i, rows.shape[0] - 1)]
        if xp is torch:
            return row.expand(tok.shape[0], 1, V), i + tok.shape[1]
        return jnp.broadcast_to(row, (tok.shape[0], 1, V)), i + tok.shape[1]

    return step


def _flip_rows():
    base = np.zeros((3, V), np.float32)
    base[0, 2], base[0, 3] = 1.0, 0.5
    base[1, EOT], base[1, 4] = 2.0, 1.5
    base[2, EOT] = 5.0
    return base


def _beam_rows():
    base = np.zeros((3, V), np.float32)
    base[0, 2], base[1, 4], base[1, EOT], base[2, EOT] = 2.0, 1.0, 2.0, 6.0
    return base


def _random_rows(seed=7, n=4):
    base = np.random.default_rng(seed).normal(size=(n, V)).astype(np.float32)
    base[:, EOT] += 1.0
    return base


CASES = [
    # (rows, phrases, weight, batch, beam, max_new)
    (_flip_rows(), [[3, 4]], 1.0, 1, 1, 4),
    (_flip_rows(), [[3]], 3.0, 1, 1, 3),
    (_beam_rows(), [[3, 4]], 1.5, 1, 3, 3),
    (_random_rows(), [[11, 10, 9]], 0.25, 2, 3, 4),
    (_random_rows(3, 5), [[3], [3, 4, 5], [7, 1]], 2.0, 2, 1, 5),
    (_random_rows(5, 6), [[3], [3, 4, 5], [7, 1]], 2.0, 2, 4, 6),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_torch_biased_decoders_match_jax(case):
    rows, phrases, weight, b, k, max_new = CASES[case]
    jt, pt = _tries(phrases, weight)
    jprompt, pprompt = jnp.zeros((b, 1), jnp.int32), torch.zeros((b, 1), dtype=torch.int64)
    js, ps = _const_step(rows, jnp), _const_step(rows, torch)
    if k == 1:
        want = jax_greedy.greedy_decode_scored(js, jnp.asarray(0), jprompt, max_new, EOT,
                                               biasing=jt)
        got = greedy.greedy_decode_scored(ps, 0, pprompt, max_new, EOT, biasing=pt)
        plain_w = jax_greedy.greedy_decode(js, jnp.asarray(0), jprompt, max_new, EOT, biasing=jt)
        plain_g = greedy.greedy_decode(ps, 0, pprompt, max_new, EOT, biasing=pt)
        np.testing.assert_array_equal(plain_g.numpy(), np.asarray(plain_w))
    else:
        want = jax_beam.beam_search(js, jnp.asarray(0), jprompt, k, max_new, EOT, biasing=jt)
        got = beam.beam_search(ps, 0, pprompt, k, max_new, EOT, biasing=pt)
        nbest_w = jax_beam.beam_search(js, jnp.asarray(0), jprompt, k, max_new, EOT,
                                       return_nbest=True, biasing=jt)
        nbest_g = beam.beam_search(ps, 0, pprompt, k, max_new, EOT, return_nbest=True,
                                   biasing=pt)
        np.testing.assert_array_equal(nbest_g[0].numpy(), np.asarray(nbest_w[0]))
        np.testing.assert_allclose(nbest_g[1].numpy(), np.asarray(nbest_w[1]), atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
    if case == 0:
        assert got[0][0, :3].tolist() == [3, 4, EOT]  # the boost flipped the argmax
    if case == 2:
        assert got[0][0, :3].tolist() == [3, 4, EOT]  # and the beam's winner


@pytest.fixture(scope="module")
def models():
    return carried_models(av=False, seed=11)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_torch_boosted_transcriber_matches_jax(models, beam_size):
    """The tiny model with phrases boosted: JAX's tokens, scores within
    1e-4, and not the unboosted tokens."""
    its = items(3, seed=40)
    phrases = ["abc", "zq", "hello"]
    jtr, ptr = transcriber_pair(models, beam_size=beam_size, boost_phrases=phrases,
                                boost_weight=6.0)
    want, got = jtr.transcribe(its), ptr.transcribe(its)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens and g.text == w.text
        assert abs(g.avg_logprob - w.avg_logprob) <= 1e-4
    plain = transcriber_pair(models, beam_size=beam_size)[1].transcribe(its)
    assert [p.tokens for p in plain] != [g.tokens for g in got]
    assert ptr._biasing.next_node.shape[1] == ptr.model.cfg.n_vocab
