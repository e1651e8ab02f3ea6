"""The port's temperature fallback (infer/pipeline.py) against the JAX
transcriber's (CPU).

With JAX's sampling noise injected per retry (the k-th retry of the n-th
fallback batch draws from ``fold_in(PRNGKey(1234), 31 n + k)`` in JAX and
seeds the port's generator ``1234 + 31 n + k``), the transcriber with
``temperature_fallback`` retries the same batches, adopts the same items
and returns JAX's final tokens and text with avg_logprob within 1e-4, on
the tiny audio-only and Whisper-Flamingo models (their logits scaled 6
times, so that a retry can score better than the greedy pass; three
audio-only items adopt one). An
unreachable threshold retries nothing; the fallback refuses beam search,
as in JAX.
"""

import numpy as np
import pytest

from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import (
    assert_same_results,
    carried_models,
    items,
    lip_feats,
    patch_jax_noise,
    transcriber_pair,
)

TEMPS = (0.5, 1.0)


@pytest.fixture(scope="module", params=[False, True], ids=["audio_only", "av"])
def models(request):
    return request.param, carried_models(av=request.param, seed=17, logit_scale=6.0)


def _items(av, seed):
    its = items(6, seed=seed)
    if av:
        its[0]["lip_feats"] = lip_feats(25, seed=seed)
        its[3]["lip_feats"] = lip_feats(11, seed=seed + 1)
    return its


def test_torch_fallback_matches_jax(monkeypatch, models):
    av, pair = models
    its = _items(av, seed=52)
    # between the items' greedy scores, so some items retry and some pass
    threshold = -0.1 if av else -0.2
    jtr, ptr = transcriber_pair(pair, temperature_fallback=TEMPS, logprob_threshold=threshold)
    seeds = patch_jax_noise(monkeypatch, ptr.max_new_tokens)
    want, got = jtr.transcribe(its), ptr.transcribe(its)
    assert_same_results(want, got)
    greedy = transcriber_pair(pair)[1].transcribe(its)
    adopted = [g.tokens != p.tokens for g, p in zip(got, greedy)]
    assert ptr.fallback_decodes >= 1
    if not av:  # retries were adopted (the AV model's retries all lose here)
        assert sum(adopted) == 3
    # two batches of 3; a retry's seed is 1234 + 31 n + k
    assert seeds and set(seeds) <= {1234 + 31 * n + k for n in (1, 2) for k in (0, 1)}
    assert ptr.fallback_decodes == len(seeds) and ptr._fallback_calls == jtr._fallback_calls == 2


def test_torch_fallback_unreachable_threshold_is_greedy(models):
    av, pair = models
    its = _items(av, seed=51)
    _, ptr = transcriber_pair(pair, temperature_fallback=TEMPS, logprob_threshold=-1e9,
                              compression_ratio_threshold=1e9)
    greedy = transcriber_pair(pair)[1].transcribe(its)
    assert ptr.transcribe(its) == greedy and ptr.fallback_decodes == 0


def test_torch_fallback_refuses_beam(models):
    _, (_, _, port) = models
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber

    with pytest.raises(ValueError, match="greedy"):
        StreamingTranscriber(port, ByteTokenizer(), beam_size=2, temperature_fallback=(0.5,))


def test_torch_fallback_compression_gate(models):
    """A row whose text compresses above the ratio threshold retries even
    when its score passes (the JAX gate's second arm)."""
    _, pair = models
    _, ptr = transcriber_pair(pair, temperature_fallback=TEMPS, logprob_threshold=-1e9,
                              compression_ratio_threshold=1.5)
    eot = ptr.tokenizer.eot
    seqs = np.asarray([[97] * 64, [97, 98, 99] + [eot] * 61])
    need = ptr._retry_mask(seqs, np.zeros(2, np.float32))
    assert need.tolist() == [True, False]
