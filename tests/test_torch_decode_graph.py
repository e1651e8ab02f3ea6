"""The greedy decode's replayed CUDA graph (``decode/greedy.py``) and the
per-row device index the transcriber gives it (``infer/pipeline.py``).

On the CPU: the decode over self caches with an index tensor (0-dim, as
the transcriber makes it, or [B]) gives the tokens and mean
log-probabilities of the host-integer index to the bit, the step a graph
captures gives the eager loop's state step by step, and the rule that engages the graph (a capturable step, logits
on CUDA, no biasing, an index tensor in every self cache) holds, so the CPU,
a biased decode and a sampled one run the eager loop and capture nothing.
On the card: two batches through ``StreamingTranscriber.transcribe``, its
producer thread running, give the eager loop's tokens and scores, with
one capture a batch and one replay a step after the prompt's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avsl_tpu_torch.decode import greedy
from avsl_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _transcriber(dtype="float32", device="cpu", batch_size=3, max_new_tokens=6, **kw):
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber
    from avsl_tpu_torch.models import build_whisper_flamingo

    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    model, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=1,
                                      use_av_hubert_encoder=True, dtype=dtype,
                                      device=device, seed=1)
    return StreamingTranscriber(model, ByteTokenizer(), audio_max_length=16000, video_frames=25,
                                batch_size=batch_size, max_new_tokens=max_new_tokens, **kw)


def _items(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        item = {"id": f"u{i}", "audio": (0.2 * rng.standard_normal(9000 + 500 * i)
                                         ).astype(np.float32)}
        if i % 3 != 2:
            item["lip_feats"] = rng.standard_normal((20, 88, 88, 1)).astype(np.float32)
        out.append(item)
    return out


def _encoded(tr, items):
    """A prepared batch's encoder outputs on the transcriber's device."""
    batch = tr._prepare_batch(items)
    with torch.inference_mode(), tr.serving_mode():
        audio = torch.from_numpy(batch.audio).to(tr.device)
        return tr.encode(audio, batch.video)


def _self_indices(cache):
    return [entry["self"]["index"] for entry in cache]


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("index", ["scalar", "rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_device_index_decode_equals_host_index(monkeypatch, dtype, index):
    """The greedy decode, scored (the transcriber's ``_decode``) and plain
    (``greedy_decode``), over a cache whose self index is a tensor (0-dim,
    the transcriber's, or [B]) equals the same decode over the
    host-integer index, to the bit."""
    tr = _transcriber(dtype)
    feats, xv = _encoded(tr, _items(3))
    length = tr.cache_len()
    with torch.inference_mode(), tr.serving_mode():
        host = tr.decode_cache(feats, xv, length)
        dev = tr.decode_cache(feats, xv, length, device_index=True)
        assert all(i == 0 and isinstance(i, int) for i in _self_indices(host))
        idx = _self_indices(dev)
        assert all(i is idx[0] for i in idx)
        assert idx[0].shape == () and idx[0].dtype == torch.int64
        if index == "rows":
            rows = torch.zeros((3,), dtype=torch.int64)
            for entry in dev:
                entry["self"]["index"] = rows
        want = tr._decode(feats, xv)
        if index == "scalar":
            monkeypatch.setattr(tr, "graphs_decode", lambda: True)  # the card's cache, here
        else:
            monkeypatch.setattr(tr, "decode_cache", lambda *a, **k: dev)
        got = tr._decode(feats, xv)

        def step(tok, c):
            return tr.model.decode(tok, None, None, c)

        eot = tr.tokenizer.eot
        plain_host = greedy.greedy_decode(step, tr.model.init_decode_cache(feats, xv, length),
                                          tr._prompt, tr.max_new_tokens, eot)
        plain_dev = greedy.greedy_decode(step, dev, tr._prompt, tr.max_new_tokens, eot,
                                         graphs=greedy.StepGraphs())
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert torch.equal(plain_host, plain_dev) and torch.equal(plain_host, want[0])
    # the random model emits no EOT here, so every step of the loop ran
    assert not (want[0] == tr.tokenizer.eot).any()


def _tensor_index_cache(shape=(), blocks=3):
    index = torch.zeros(shape, dtype=torch.int64)
    return [{"self": {"k": None, "v": None, "index": index}, "cross": {}} for _ in range(blocks)]


@pytest.mark.parametrize("case, want", [
    ("scalar_index", True),
    ("rows_index", True),
    ("cpu_logits", False),
    ("not_capturable", False),  # sampled decoding, and callers that do not say
    ("biasing", False),
    ("host_index", False),
    ("one_host_index", False),
    ("other_cache", False),
])
def test_torch_graph_engagement_rule(case, want):
    """``replays``: a capturable step, CUDA logits, no biasing and an
    index tensor in every self cache, and nothing less."""
    logits = SimpleNamespace(is_cuda=case != "cpu_logits")
    cache = _tensor_index_cache((2,) if case == "rows_index" else ())
    if case == "host_index":
        cache = [{"self": {**e["self"], "index": 3}} for e in cache]
    if case == "one_host_index":
        cache[1] = {"self": {**cache[1]["self"], "index": 3}}
    if case == "other_cache":
        cache = 0
    biasing = object() if case == "biasing" else None
    graphs = None if case == "not_capturable" else greedy.StepGraphs()
    assert greedy.replays(logits, cache, biasing, graphs) is want


@pytest.mark.parametrize("case", ["cpu", "biasing", "sampled"])
def test_torch_eager_loop_captures_nothing(monkeypatch, case):
    """On the CPU, with phrase boosting and with sampled decoding, the
    decode runs the eager loop: no capture, no replay, and a
    ``decode.step`` span a step as before."""
    if case == "biasing":
        tr = _transcriber(boost_phrases=["ab"])
        assert not tr.graphs_decode()
    else:
        tr = _transcriber()
        assert not tr.graphs_decode()  # on the CPU
        monkeypatch.setattr(tr, "graphs_decode", lambda: True)
    items = _items(4)
    with spans.recording() as rec:
        if case == "sampled":
            feats, xv = _encoded(tr, items[:3])
            with torch.inference_mode(), tr.serving_mode():
                tr._decode(feats, xv, 0.7, torch.Generator().manual_seed(3))
        else:
            tr.transcribe(items)
    assert "decode.graph_captures" not in rec.counters
    assert "decode.graph_replays" not in rec.counters
    names = [s.name for s in rec.spans]
    assert "decode.capture" not in names and names.count("decode.step") >= 1


class _EagerGraphs(greedy.StepGraphs):
    """Stands in for the CUDA graph on the CPU: the captured step runs
    eagerly at each replay, so the graphed loop's state updates, in place
    in its buffers, are what the test compares."""

    def capture(self, fn, device):
        spans.count("decode.graph_captures", 1)
        return SimpleNamespace(replay=fn)


def _table_step(table):
    """A step over a logits table [positions, B, V] read at the self
    cache's 0-dim index."""
    def step(tok, cache):
        idx = cache[0]["self"]["index"]
        logits = table[idx][:, None, :].expand(-1, tok.shape[1], -1)
        return logits, [{"self": {"index": idx + tok.shape[1]}} for _ in cache]
    return step


@pytest.mark.parametrize("scored", [False, True])
@pytest.mark.parametrize("source", ["table", "model"])
def test_torch_graphed_step_updates_equal_the_eager_loop(monkeypatch, source, scored):
    """The step the graph captures, run once a replay, gives the eager
    loop's tokens, scores and steps: rows that finish at different steps
    (EOT after EOT, no score or count past it), an early exit once every
    row has finished, and the self index advanced in place."""
    eot, max_new = 0, 9
    if source == "table":
        rng = np.random.default_rng(int(scored))
        b, v = 4, 11
        table = torch.from_numpy((2.0 * rng.normal(size=(max_new + 2, b, v))).astype(np.float32))
        table[4, 1:, eot] += 9.0  # rows 1-3 finish at the third step, then pick others
        table[8, 0, eot] += 9.0  # row 0 at the last but one: the loop stops early
        step = _table_step(table)
        prompt = torch.ones((b, 2), dtype=torch.int64)

        def cache():
            return [{"self": {"index": torch.zeros((), dtype=torch.int64)}} for _ in range(2)]
    else:
        tr = _transcriber()
        feats, xv = _encoded(tr, _items(3))
        eot, prompt = tr.tokenizer.eot, tr._prompt

        def step(tok, c):
            return tr.model.decode(tok, None, None, c)

        def cache():
            return tr.decode_cache(feats, xv, tr.cache_len(), device_index=True)

    decode = greedy.greedy_decode_scored if scored else greedy.greedy_decode

    def run(graphs):
        with spans.recording() as rec, torch.inference_mode():
            got = decode(step, cache(), prompt, max_new, eot, graphs=graphs)
        return got if scored else (got,), rec

    want, eager = run(None)
    monkeypatch.setattr(greedy, "replays", lambda logits, cache, biasing, graphs: True)
    got, graphed = run(_EagerGraphs())
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    n_steps = [s.name for s in eager.spans].count("decode.step")
    assert [s.name for s in graphed.spans].count("decode.step") == n_steps
    assert graphed.counters == {"decode.graph_captures": 1, "decode.graph_replays": n_steps}
    if source == "table":
        assert n_steps == 7 and (want[0][:, -1] == eot).all()


# -- on the card -------------------------------------------------------------


@pytest.mark.card
def test_torch_graphed_transcribe_equals_eager_on_the_card(monkeypatch):
    """A small Whisper-Flamingo in bf16 on the card: two batches through
    ``transcribe`` (the producer thread preparing the second while the
    first decodes) capture one graph a batch and replay it once a step
    after the prompt's, and give the tokens and mean log-probabilities of
    the same transcriber forced down the eager loop, to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the graph is captured and replayed on the chip")
    tr = _transcriber("bfloat16", "cuda", batch_size=4, max_new_tokens=12)
    assert tr.graphs_decode()
    items = _items(7, seed=5)
    with spans.recording() as rec:
        got = tr.transcribe(items)
    names = [s.name for s in rec.spans]
    assert rec.counters["decode.graph_captures"] == names.count("decode.prefill") == 2
    assert names.count("decode.capture") == 2
    assert rec.counters["decode.graph_replays"] == names.count("decode.step") >= 2
    feats, xv = _encoded(tr, items[:4])
    with torch.inference_mode(), tr.serving_mode():
        graphed = tr._decode(feats, xv)

    monkeypatch.setattr(tr, "graphs_decode", lambda: False)
    with spans.recording() as eager_rec:
        want = tr.transcribe(items)
    assert "decode.graph_captures" not in eager_rec.counters
    with torch.inference_mode(), tr.serving_mode():
        eager = tr._decode(feats, xv)
    assert [(r.id, r.tokens, r.avg_logprob) for r in got] == \
        [(r.id, r.tokens, r.avg_logprob) for r in want]
    assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
    print(f"replayed steps {rec.counters['decode.graph_replays']} over 2 batches; "
          f"tokens {graphed[0].tolist()}")
