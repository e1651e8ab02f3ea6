"""Transcription serving daemon: an HTTP front over a dynamic batcher.

Port of ``avsl_tpu/infer/server.py``, with its protocol. Requests that
arrive within ``max_wait_ms`` of one another share one of the
transcriber's fixed-size batches. One scheduler thread is the only client
of the device: it runs every batch (on the transcriber's CUDA device, made
current in that thread), while the HTTP handler threads only parse JSON,
decode base64 PCM into numpy and, for ``long`` requests, split and stitch
on the host. A batch that raises fails its own requests (HTTP 500, counted
in ``n_errors``) and the daemon serves the next one.

Protocol (JSON over HTTP, standard library only):

    POST /v1/transcribe   {"id": ..., "audio": <wav path>,
                           "audio_pcm_b64": <base64 float32 PCM at 16 kHz>,
                           "lip_video": <mp4 path>, "video": <mp4 path>,
                           "long": <bool>}
      -> {"id", "text", "has_video", "avg_logprob", "latency_ms"}
         (+ "words" with word timestamps; with long=true "segments":
          [{start_s, end_s, text, avg_logprob}], windows cut at pauses and
          batched like other requests, infer/longform.py)
    GET  /healthz         -> {"ok": true, "batch_size", "quantize", "device"}
    GET  /stats           -> latency percentiles and batch occupancy (and
                             "speculative", the draft's acceptance, once a
                             speculative batch has run)

A full queue answers 429, a request that waits too long 504, a malformed
one 400. Use :class:`TranscriptionServer` directly or through
``python -m avsl_tpu_torch.cli.serve``. With a transcriber on a mesh of
several ranks the server's rank leads (``StreamingTranscriber.lead``): the
other ranks, in ``StreamingTranscriber.follow``, run each of its batches
with it, and stop when the server stops.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Full, Queue
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from avsl_tpu_torch.infer.longform import split_item, stitch

# how long a handler waits for its reply, for one request and for all the
# windows of a long one
REQUEST_TIMEOUT_S = 300.0
LONG_REQUEST_TIMEOUT_S = 600.0


@dataclass
class _Pending:
    item: Dict[str, Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Any] = None
    error: Optional[str] = None
    t_enqueue: float = field(default_factory=time.perf_counter)
    latency_ms: float = 0.0


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies_ms: List[float] = []
        self.occupancies: List[int] = []
        self.n_requests = 0
        self.n_errors = 0
        self.n_rejected = 0

    def record_batch(self, occupancy: int, latencies_ms: List[float], errors: int = 0):
        with self.lock:
            self.occupancies.append(occupancy)
            self.latencies_ms.extend(latencies_ms)
            self.n_requests += occupancy
            self.n_errors += errors
            # bounded memory: the newest 10k samples
            self.latencies_ms = self.latencies_ms[-10000:]
            self.occupancies = self.occupancies[-10000:]

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            lat = np.asarray(self.latencies_ms, np.float64)
            occ = np.asarray(self.occupancies, np.float64)
            out = {"n_requests": self.n_requests, "n_errors": self.n_errors,
                   "n_rejected": self.n_rejected, "n_batches": int(occ.size)}
            if lat.size:
                out["latency_ms"] = {
                    "p50": round(float(np.percentile(lat, 50)), 1),
                    "p95": round(float(np.percentile(lat, 95)), 1),
                    "max": round(float(lat.max()), 1),
                }
            if occ.size:
                out["batch_occupancy"] = {"mean": round(float(occ.mean()), 2),
                                          "max": int(occ.max())}
            return out


def _segment_payload(s) -> Dict[str, Any]:
    out = {"start_s": s.start_s, "end_s": s.end_s, "text": s.text, "avg_logprob": s.avg_logprob}
    if s.words is not None:
        out["words"] = s.words
    return out


class TranscriptionServer:
    """Dynamic-batching scheduler and stdlib HTTP front for a
    :class:`~avsl_tpu_torch.infer.StreamingTranscriber`.

    ``max_wait_ms`` trades tail latency for batch occupancy: the first
    request in an empty queue waits at most this long for companions; a
    full queue of ``max_queue`` requests sheds load with 429.
    """

    def __init__(self, transcriber, host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 30.0, max_queue: int = 256):
        self.transcriber = transcriber
        from avsl_tpu_torch.core.mesh import world_size

        # on a mesh of several ranks this one leads: the others run its batches
        self._leads = getattr(transcriber, "mesh", None) is not None and world_size() > 1
        if self._leads:
            transcriber.lead(True)
        self.max_wait_ms = float(max_wait_ms)
        self.stats = _Stats()
        self._queue: "Queue[_Pending]" = Queue(maxsize=max(int(max_queue), 1))
        self._stop = threading.Event()
        self._scheduler = threading.Thread(target=self._run_scheduler, daemon=True)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: Dict[str, Any]):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True, "batch_size": server.transcriber.batch_size,
                                      "quantize": server.transcriber.quantize,
                                      "device": str(server.transcriber.device)})
                elif self.path == "/stats":
                    snap = server.stats.snapshot()
                    spec = server.transcriber.spec_stats()
                    if spec is not None:
                        snap["speculative"] = spec
                    self._reply(200, snap)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/transcribe":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    item = server._parse_item(req)
                except Exception as e:  # a malformed request
                    self._reply(400, {"error": str(e)})
                    return
                if req.get("long"):
                    self._long(item)
                    return
                pending = server.submit(item)
                if pending is None:
                    self._reply(429, {"error": "server overloaded"})
                    return
                if not pending.done.wait(timeout=REQUEST_TIMEOUT_S):
                    self._reply(504, {"error": "timed out"})
                    return
                if pending.error is not None:
                    self._reply(500, {"error": pending.error})
                    return
                r = pending.result
                payload = {"id": r.id, "text": r.text, "has_video": r.has_video,
                           "avg_logprob": r.avg_logprob,
                           "latency_ms": round(pending.latency_ms, 1)}
                if r.words is not None:
                    payload["words"] = r.words
                self._reply(200, payload)

            def _long(self, item):
                """Split on this thread, submit every window as a request
                (windows of concurrent long requests share batches), stitch."""
                tr = server.transcriber
                try:
                    windows, spans = split_item(item, tr.audio_max_length, tr.video_frames,
                                                crop=tr.crop)
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                pendings = [server.submit(w) for w in windows]
                if any(p is None for p in pendings):
                    # some windows were shed: the accepted ones still run,
                    # but this request fails fast
                    self._reply(429, {"error": "server overloaded"})
                    return
                t_left = LONG_REQUEST_TIMEOUT_S
                for p in pendings:
                    t0 = time.perf_counter()
                    if not p.done.wait(timeout=max(t_left, 0.001)):
                        self._reply(504, {"error": "timed out"})
                        return
                    t_left -= time.perf_counter() - t0
                errs = [p.error for p in pendings if p.error is not None]
                if errs:
                    self._reply(500, {"error": errs[0]})
                    return
                r = stitch(item.get("id", ""), [p.result for p in pendings], spans)
                self._reply(200, {
                    "id": r.id, "text": r.text, "has_video": r.has_video,
                    "segments": [_segment_payload(s) for s in r.segments],
                    "latency_ms": round(max(p.latency_ms for p in pendings), 1),
                })

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http.daemon_threads = True
        self._http_thread = threading.Thread(target=self._http.serve_forever, daemon=True)

    # -- request intake -------------------------------------------------

    @staticmethod
    def _parse_item(req: Dict[str, Any]) -> Dict[str, Any]:
        item: Dict[str, Any] = {"id": str(req.get("id", ""))}
        if "audio_pcm_b64" in req:
            pcm = np.frombuffer(base64.b64decode(req["audio_pcm_b64"]), np.float32)
            if pcm.size == 0:
                raise ValueError("empty audio_pcm_b64")
            item["audio"] = pcm
        elif "audio" in req:
            item["audio"] = str(req["audio"])
        else:
            raise ValueError("need 'audio' (wav path) or 'audio_pcm_b64'")
        for k in ("lip_video", "video"):
            if req.get(k):
                item[k] = str(req[k])
        return item

    def submit(self, item: Dict[str, Any]) -> Optional[_Pending]:
        """Enqueue one request (``lip_feats`` arrays too); wait on
        ``pending.done``. Returns None when the queue is full."""
        pending = _Pending(item=item)
        try:
            self._queue.put_nowait(pending)
        except Full:
            with self.stats.lock:
                self.stats.n_rejected += 1
            return None
        return pending

    # -- scheduler ------------------------------------------------------

    def _gather(self) -> List[_Pending]:
        """Block for the first request, then take up to a batch within the
        wait window."""
        try:
            first = self._queue.get(timeout=0.2)
        except Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.transcriber.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except Empty:
                break
        return batch

    def _run_scheduler(self):
        device = torch.device(self.transcriber.device)
        if device.type == "cuda":  # this thread launches every batch there
            torch.cuda.set_device(torch.cuda.current_device() if device.index is None
                                  else device.index)
        while not self._stop.is_set():
            batch = self._gather()
            if not batch:
                continue
            errors = 0
            try:
                results = self.transcriber.transcribe_batch([p.item for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
                    p.latency_ms = 1e3 * (time.perf_counter() - p.t_enqueue)
            except Exception as e:  # the batch fails, the daemon goes on
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
                errors = len(batch)
            finally:
                for p in batch:
                    p.done.set()
            self.stats.record_batch(
                occupancy=len(batch),
                latencies_ms=[p.latency_ms for p in batch if p.error is None],
                errors=errors,
            )

    # -- lifecycle ------------------------------------------------------

    @property
    def address(self):
        return self._http.server_address

    def start(self) -> "TranscriptionServer":
        self._scheduler.start()
        self._http_thread.start()
        return self

    def serve_forever(self):
        """Serve until SIGTERM or Ctrl-C, then drain and stop."""
        import signal

        try:
            signal.signal(signal.SIGTERM, lambda *_: self._stop.set())
        except ValueError:  # not the main thread
            pass
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        if self._http_thread.is_alive():  # shutdown() waits for serve_forever
            self._http.shutdown()
        self._http.server_close()
        if self._scheduler.is_alive():
            self._scheduler.join(timeout=None if self._leads else 5.0)
        if self._leads:  # the followers stop after the last batch
            self.transcriber.lead(False)
            self._leads = False
        # fail what is still queued: its handlers wait on pending.done
        while True:
            try:
                p = self._queue.get_nowait()
            except Empty:
                break
            p.error = "server stopped"
            p.done.set()
