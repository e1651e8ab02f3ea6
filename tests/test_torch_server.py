"""The port's serving daemon (infer/server.py) on the CPU, its answers
held against the JAX transcriber on the same carried weights.

HTTP round trips (``/healthz``, ``/stats``, ``/v1/transcribe`` with
base64 PCM and ``long``), concurrent requests coalesced into fewer
batches, lip-feature items submitted directly, word timestamps in the
replies, a streaming session routed through the batcher; and the error
paths: 400 for malformed requests, 404, 429 from a full queue, 500 for a
failed batch (the daemon serves the next one) and 504 for a request that
waits too long. Every transcript equals the JAX transcriber's for the
same item (tokens, text, avg_logprob within 1e-4, words).
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from avsl_tpu_torch.infer import StreamingSession, TranscriptionServer
from avsl_tpu_torch.infer import server as server_mod
from test_torch_flamingo_common import one_torch_thread  # noqa: F401
from torch_serving_fixtures import (
    SR,
    carried_models,
    lip_feats,
    speech_with_pauses,
    transcriber_pair,
)


@pytest.fixture(scope="module")
def pair():
    return transcriber_pair(carried_models(av=True, seed=61), batch_size=4, max_new_tokens=4,
                            word_timestamps=True)


@pytest.fixture(scope="module")
def server(pair):
    srv = TranscriptionServer(pair[1], port=0, max_wait_ms=150.0).start()
    yield srv
    srv.stop()


def _url(srv, path):
    host, port = srv.address
    return f"http://{host}:{port}{path}"


def _post(srv, payload, timeout=120, raw=None):
    req = urllib.request.Request(_url(srv, "/v1/transcribe"),
                                 data=raw if raw is not None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _pcm(seconds=0.5, freq=300.0):
    t = np.arange(int(SR * seconds)) / SR
    return (0.2 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _b64(pcm):
    return base64.b64encode(pcm.tobytes()).decode()


def _same(reply, want):
    assert (reply["id"], reply["text"], reply["has_video"]) == (want.id, want.text, want.has_video)
    assert abs(reply["avg_logprob"] - want.avg_logprob) <= 1e-4
    assert reply["words"] == want.words


def test_torch_server_healthz_stats_and_single_request(server, pair):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["batch_size"] == 4 and health["device"] == "cpu"
    pcm = _pcm()
    status, out = _post(server, {"id": "solo", "audio_pcm_b64": _b64(pcm)})
    assert status == 200 and out["latency_ms"] > 0
    _same(out, pair[0].transcribe_batch([{"id": "solo", "audio": pcm}])[0])
    with urllib.request.urlopen(_url(server, "/stats"), timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["n_requests"] >= 1 and stats["n_errors"] == 0 and "latency_ms" in stats


def test_torch_server_batches_concurrent_requests(server, pair):
    before = server.stats.snapshot().get("n_batches", 0)
    pcms = {i: _pcm(0.3 + 0.1 * i, 200 + 40 * i) for i in range(4)}
    results, errs = {}, []

    def fire(i):
        try:
            results[i] = _post(server, {"id": f"r{i}", "audio_pcm_b64": _b64(pcms[i])})
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errs and len(results) == 4
    for i, (status, out) in results.items():
        assert status == 200
        _same(out, pair[0].transcribe_batch([{"id": f"r{i}", "audio": pcms[i]}])[0])
    snap = server.stats.snapshot()
    assert snap["batch_occupancy"]["max"] >= 2
    assert snap["n_batches"] - before < 4  # coalesced, not one batch a request


def test_torch_server_submit_lip_features(server, pair):
    its = [{"id": "v0", "audio": _pcm(0.7), "lip_feats": lip_feats(18, seed=62)},
           {"id": "v1", "audio": _pcm(0.4, 500)}]
    pendings = [server.submit(dict(it)) for it in its]
    for p in pendings:
        assert p.done.wait(120) and p.error is None
    want = pair[0].transcribe_batch(its)
    for p, w in zip(pendings, want):
        r = p.result
        assert (r.id, r.tokens, r.has_video, r.words) == (w.id, w.tokens, w.has_video, w.words)
        assert abs(r.avg_logprob - w.avg_logprob) <= 1e-4
    assert [p.result.has_video for p in pendings] == [True, False]


@pytest.mark.parametrize("payload,raw", [
    ({"id": "bad"}, None),
    ({"id": "empty", "audio_pcm_b64": ""}, None),
    (None, b"{not json"),
    ({"id": "raw-long", "audio_pcm_b64": _b64(_pcm()), "video": "x.mp4", "long": True}, None),
])
def test_torch_server_rejects_malformed_requests(server, payload, raw):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, payload, raw=raw)
    assert ei.value.code == 400


def test_torch_server_unknown_paths(server):
    for req in (urllib.request.Request(_url(server, "/nope")),
                urllib.request.Request(_url(server, "/v1/other"), data=b"{}")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 404


def test_torch_server_long_request(server, pair):
    audio, _ = speech_with_pauses(n_bursts=3, burst_s=0.8, pause_s=0.3)
    status, out = _post(server, {"id": "L", "audio_pcm_b64": _b64(audio), "long": True},
                        timeout=600)
    want = pair[0].transcribe_long([{"id": "L", "audio": audio}])[0]
    assert status == 200 and (out["id"], out["text"]) == (want.id, want.text)
    assert len(out["segments"]) == len(want.segments) >= 2
    for s, w in zip(out["segments"], want.segments):
        assert (s["start_s"], s["end_s"], s["text"], s["words"]) == \
            (w.start_s, w.end_s, w.text, w.words)
        assert abs(s["avg_logprob"] - w.avg_logprob) <= 1e-4
    assert out["segments"][0]["start_s"] == 0.0
    assert abs(out["segments"][-1]["end_s"] - len(audio) / SR) < 1e-3


def test_torch_server_streaming_session_through_batcher(server, pair):
    def via_server(items):
        pendings = [server.submit(it) for it in items]
        for p in pendings:
            p.done.wait(300)
        return [p.result for p in pendings]

    stream = np.concatenate([np.zeros(6400, np.float32), _pcm(0.6, 250), np.zeros(9600, np.float32),
                             _pcm(0.5, 420), np.zeros(8000, np.float32)])
    segs = []
    routed = StreamingSession(pair[1], stream_id="st", transcribe_fn=via_server)
    direct = StreamingSession(pair[1], stream_id="st")
    for sess in (routed, direct):
        out = []
        for i in range(0, len(stream), 1600):
            out.extend(sess.feed(stream[i: i + 1600]))
        segs.append(out + sess.flush())
    assert len(segs[0]) == 2 and [vars(s) for s in segs[0]] == [vars(s) for s in segs[1]]


def test_torch_server_sheds_load_with_429(pair):
    """A bounded queue rejects the overflow with 429 while the queued
    request completes once the scheduler drains (started only after the
    queue is full)."""
    srv = TranscriptionServer(pair[1], port=0, max_wait_ms=1.0, max_queue=1)
    srv._http_thread.start()
    try:
        first = {}
        t = threading.Thread(target=lambda: first.setdefault(
            "resp", _post(srv, {"id": "q1", "audio_pcm_b64": _b64(_pcm(freq=260))}, timeout=180)))
        t.start()
        for _ in range(200):
            if srv._queue.full():
                break
            time.sleep(0.02)
        assert srv._queue.full()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, {"id": "q2", "audio_pcm_b64": _b64(_pcm(freq=300))})
        assert ei.value.code == 429 and srv.stats.snapshot()["n_rejected"] == 1
        srv._scheduler.start()
        t.join(timeout=180)
        assert first["resp"][0] == 200 and first["resp"][1]["id"] == "q1"
    finally:
        srv.stop()


def test_torch_server_times_out_with_504(pair, monkeypatch):
    monkeypatch.setattr(server_mod, "REQUEST_TIMEOUT_S", 0.3)
    srv = TranscriptionServer(pair[1], port=0)
    srv._http_thread.start()  # the scheduler never runs
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, {"id": "slow", "audio_pcm_b64": _b64(_pcm())})
        assert ei.value.code == 504
    finally:
        srv.stop()


def test_torch_server_batch_failure_isolated(server):
    tr = server.transcriber
    original = tr.transcribe_batch
    state = {"raised": False}

    def boom(items):
        if not state["raised"]:
            state["raised"] = True
            raise RuntimeError("injected device failure")
        return original(items)

    before = server.stats.snapshot()["n_errors"]
    tr.transcribe_batch = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, {"id": "f1", "audio_pcm_b64": _b64(_pcm(freq=310))})
        assert ei.value.code == 500 and "injected device failure" in ei.value.read().decode()
        status, out = _post(server, {"id": "f2", "audio_pcm_b64": _b64(_pcm(freq=320))})
        assert status == 200 and out["id"] == "f2"
        assert server.stats.snapshot()["n_errors"] == before + 1
    finally:
        del tr.transcribe_batch
