"""Forced-alignment CLI of the port: transcripts -> word-level timestamps.

``python -m avsl_tpu_torch.cli.align --audio seg.wav [--video seg-lip.mp4]
--text "..." [--config avhubert.yaml] [--ckpt_dir ...] [--output out.json]
[--device cuda|cpu]`` or ``--csv segments.csv`` (columns: id, audio,
[video], text).

Port of ``avsl_tpu/cli/align.py``: the AV-HuBERT CTC head over the
segment's 104-dim stacked-logfbank (+ lip clip) features, then a float64
log-softmax and the Viterbi alignment of the KNOWN transcript onto the
25 Hz CTC frames on the host (``decode/ctc.py::ctc_forced_align``), and
word-level timestamps. Items are padded to ``--bucket`` frame multiples
with no padding mask, as in JAX; the pad frames are left out of the
alignment (the DP runs on true frames only). A row without text, or with
more emission slots than frames, gets a per-row ``error`` and the batch
goes on. ``--smoke`` aligns " hello world" onto a 1 s 300 Hz tone with
the tiny card. Without ``--ckpt_dir`` the weights are random (seed 0).

Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    p = argparse.ArgumentParser()
    p.add_argument("--audio", default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--text", default=None)
    p.add_argument("--id", default="0")
    p.add_argument("--csv", default=None)
    p.add_argument("--config", default=None, help="AV-HuBERT model card YAML")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--frame_rate", type=float, default=25.0)
    p.add_argument("--bucket", type=int, default=32,
                   help="frame-count bucket granularity (static shapes)")
    p.add_argument("--tiny", action="store_true", help="tiny_test model card (tests/CI)")
    p.add_argument("--smoke", action="store_true",
                   help="--tiny + synthetic audio (CI health check)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from avsl_tpu_torch.cli._avh_common import (
        load_row_features,
        maybe_restore_variables,
        rows_from_args,
    )
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.decode.ctc import ctc_forced_align, word_alignments
    from avsl_tpu_torch.models import build_avhubert

    tokenizer = get_tokenizer(None, "en")
    if args.smoke or args.tiny:
        cfg = AVHuBERTConfig.tiny_test(vocab_size=tokenizer.vocab_size)
    elif args.config:
        cfg = AVHuBERTConfig.from_yaml(args.config)
    else:
        cfg = AVHuBERTConfig(vocab_size=tokenizer.vocab_size)
    if args.smoke:
        sr = 16000
        rows = [{
            "id": "smoke",
            "audio": (0.1 * np.sin(2 * np.pi * 300 * np.arange(sr) / sr)).astype(np.float32),
            "text": " hello world",
        }]
    else:
        rows = rows_from_args(args)
        if args.text is not None and not args.csv:
            rows[0]["text"] = args.text
    device = resolve_device(args.device)
    model = None

    def log_softmax(x):
        x = x - x.max(-1, keepdims=True)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    results: List[Dict[str, Any]] = []
    for row in rows:
        if not row.get("text"):
            results.append({"id": row.get("id", "?"), "error": "missing transcript text"})
            continue
        pad_a, pad_v, t = load_row_features(row, args.bucket, device=device)
        if model is None:
            model = maybe_restore_variables(args.ckpt_dir,
                                            build_avhubert(cfg, "ctc", device=device))
        with torch.no_grad():
            logits = model(audio=torch.from_numpy(pad_a).to(device),
                           video=torch.from_numpy(pad_v).to(device))
        logits = logits.cpu().numpy()[0, :t]
        tokens = tokenizer.encode(row["text"])
        lp = log_softmax(logits.astype(np.float64))
        try:
            spans, score = ctc_forced_align(lp, tokens, blank_id=cfg.pad_token_id)
        except ValueError as e:  # infeasible: too many tokens for the frames
            results.append({"id": row["id"], "error": str(e)})
            continue
        words = word_alignments(tokens, spans, tokenizer, frame_rate_hz=args.frame_rate)
        results.append({"id": row["id"], "score": round(score, 3), "n_frames": t,
                        "words": words})

    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    for r in results[:10]:
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
