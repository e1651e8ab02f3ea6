"""Live streaming sessions of the port (infer/streaming.py) against the
JAX package's (CPU).

The same PCM fed in the same chunks to a JAX session over the JAX
transcriber and a port session over the port transcriber (the tiny model
on carried weights, word timestamps on) gives equal segments: start, end,
text, avg_logprob within 1e-4 and words, for pauses at any chunking, a
force cut at the window, silence only, an open utterance flushed, and one
oversized chunk. A session can route through a ``transcribe_fn``.
"""

import numpy as np
import pytest

from avsl_tpu.infer.streaming import StreamingSession as JaxSession
from avsl_tpu_torch.infer.streaming import StreamingSession
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import SR, carried_models, transcriber_pair


def _tone(seconds, freq=300.0, amp=0.3, seed=0):
    t = np.arange(int(SR * seconds)) / SR
    noise = 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (amp * np.sin(2 * np.pi * freq * t) + noise).astype(np.float32)


def _silence(seconds):
    return np.zeros((int(SR * seconds),), np.float32)


STREAMS = {
    "pauses": np.concatenate([_silence(0.4), _tone(0.6, 250), _silence(0.6), _tone(0.5, 420, seed=1),
                              _silence(0.5)]),
    "force_cut": _tone(2.5, 300, seed=2),
    "silence": _silence(3.0),
    "open_utterance": _tone(0.5, seed=3),
    "oversized_chunk": np.concatenate([_tone(2.2, 330, seed=4), _silence(0.6)]),
}


@pytest.fixture(scope="module")
def transcribers():
    return transcriber_pair(carried_models(av=False, seed=41), batch_size=2, max_new_tokens=4,
                            word_timestamps=True)


def _run(session, stream, chunk):
    segs = []
    for i in range(0, len(stream), chunk):
        segs.extend(session.feed(stream[i: i + chunk]))
    return segs + session.flush()


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("chunk", [1600, 3777, 10 ** 6])
def test_torch_streaming_matches_jax(transcribers, name, chunk):
    jtr, ptr = transcribers
    want = _run(JaxSession(jtr, stream_id=name), STREAMS[name], chunk)
    got = _run(StreamingSession(ptr, stream_id=name), STREAMS[name], chunk)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert (g.start_s, g.end_s, g.text, g.words) == (w.start_s, w.end_s, w.text, w.words)
        assert abs(g.avg_logprob - w.avg_logprob) <= 1e-4
        assert g.end_s - g.start_s <= ptr.audio_max_length / SR + 1e-6
    expected = {"pauses": 2, "silence": 0, "open_utterance": 1}
    if name in expected:
        assert len(got) == expected[name]
    elif name in ("force_cut", "oversized_chunk"):
        assert len(got) >= 3


def test_torch_streaming_session_routes_and_closes(transcribers):
    _, ptr = transcribers
    seen = []

    def sink(items):
        seen.extend(it["id"] for it in items)
        return ptr.transcribe_batch(items)

    sess = StreamingSession(ptr, stream_id="s", transcribe_fn=sink)
    segs = _run(sess, STREAMS["pauses"], 1600)
    assert seen == ["s#s0", "s#s1"] and len(segs) == 2
    with pytest.raises(RuntimeError):
        sess.feed(_tone(0.1))
