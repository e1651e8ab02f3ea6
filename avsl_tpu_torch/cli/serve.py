"""Serving daemon CLI of the port: ``python -m avsl_tpu_torch.cli.serve
[--config cfg.yaml] [--ckpt_dir dir] [--port 8080] [--max_wait_ms 30]
[--device cuda] [--smoke]``.

Port of ``avsl_tpu/cli/serve.py``: starts the dynamic-batching HTTP
transcription server (:class:`avsl_tpu_torch.infer.TranscriptionServer`)
on the JAX CLI's default model, ``FlamingoTrainConfig()`` (Whisper
large-v2 with the AV-HuBERT video tower and gated cross-attention; with
``--smoke`` the tiny test model at 1 s windows), on ``--device`` (the card
unless ``cpu`` is asked for). It takes the JAX CLI's flags: ``--quantize
int8``, ``--kv_int8`` and ``--draft_model``/``--draft_ckpt``/``--spec_k``
as ``cli/transcribe.py`` does. ``--model_parallel``/``--data_parallel``
serve on a mesh, one process a rank under ``python -m
torch.distributed.run``: rank 0 owns the HTTP daemon and sends each batch
to the other ranks, which run it with it and stop when it stops.
``/healthz`` reports ``quantize``, ``/stats`` the draft's acceptance.
``--smoke`` binds, prints ``{"ok": true, "address": ...}`` and stops.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    from avsl_tpu_torch.cli._serving_common import build_transcriber
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.infer import TranscriptionServer

    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--max_wait_ms", type=float, default=30.0)
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only int8 serving (models/quant.py)")
    p.add_argument("--kv_int8", action="store_true",
                   help="int8-compress the cross-attn/xv K/V the decode loop re-reads")
    p.add_argument("--temperature_fallback", default="", help="comma list, e.g. 0.2,0.4")
    p.add_argument("--logprob_threshold", type=float, default=-1.0)
    p.add_argument("--word_timestamps", action="store_true",
                   help="attach cross-attention DTW word times to replies")
    p.add_argument("--draft_model", default=None,
                   help="draft Whisper preset for speculative decoding, e.g. tiny")
    p.add_argument("--draft_ckpt", default=None)
    p.add_argument("--spec_k", type=int, default=4, help="draft tokens per verify pass")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)

    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if args.smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000

    transcriber = build_transcriber(args, cfg)
    if transcriber.mesh is not None:
        from avsl_tpu_torch.core.mesh import rank

        if rank() != 0:  # a follower runs rank 0's batches until it stops
            transcriber.follow()
            return None
    server = TranscriptionServer(transcriber, host=args.host, port=args.port,
                                 max_wait_ms=args.max_wait_ms)
    host, port = server.address
    if args.smoke:
        server.start()
        print(json.dumps({"ok": True, "address": f"http://{host}:{port}"}))
        server.stop()
        return server
    print(f"serving on http://{host}:{port}  (batch={args.batch_size}, "
          f"wait={args.max_wait_ms}ms, device={transcriber.device})", flush=True)
    server.serve_forever()
    return server


if __name__ == "__main__":
    main()
