"""Batch transcription CLI of the port: directory of segments -> transcripts JSON.

Usage: ``python -m avsl_tpu_torch.cli.transcribe --input <dir-or-csv>
[--config cfg.yaml] [--ckpt_dir dir] [--device cuda] [--output out.json]
[--smoke]``

Port of ``avsl_tpu/cli/transcribe.py``: audio wavs
with optional lip mp4s (``<stem>-lip.mp4``) or, without one, raw closeups
(``<stem>-video.mp4``, lip-cropped by the transcriber's default
``host_refined`` mode, which needs OpenCV), missing-modality robust.
Without ``--config`` the model is the JAX CLI's default,
``FlamingoTrainConfig()``: Whisper large-v2 with the AV-HuBERT video tower
and gated cross-attention (``--smoke``: the tiny test model).
``--ckpt_dir`` serves the latest checkpoint a trainer (``cli/finetune.py``)
wrote there; without it the weights are seeded random.
``--temperature_fallback 0.2,0.4`` re-decodes low-confidence items by
sampling, ``--word_timestamps`` adds each row's ``words``, and
``--detect_language`` its ``language`` and ``language_prob`` (it needs
float weights: with ``--quantize`` it exits). ``--quantize int8`` serves
int8 weights, ``--kv_int8`` an int8 cross-attention cache, and
``--draft_model tiny --draft_ckpt <dir> [--spec_k 4]`` decodes
speculatively against that draft (``cli/_serving_common.py``).
``--model_parallel M --data_parallel D`` serve on a mesh of D x M ranks,
one process each: ``python -m torch.distributed.run --nproc_per_node
$((D*M)) -m avsl_tpu_torch.cli.transcribe ...``. Every rank reads the same
inputs; rank 0 writes ``--output`` and prints.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional


def collect_items(input_path: str) -> List[Dict[str, Any]]:
    items: List[Dict[str, Any]] = []
    if input_path.endswith(".csv"):
        import pandas as pd

        from avsl_tpu_torch.cli._serving_common import csv_cell

        for row in pd.read_csv(input_path).to_dict("records"):
            items.append(
                {
                    "id": csv_cell(row, "id", "segment_id") or str(len(items)),
                    "audio": csv_cell(row, "audio", "audio_abs"),
                    "lip_video": csv_cell(row, "lip_video", "lip_video_abs"),
                }
            )
        return [it for it in items if it["audio"]]
    for fname in sorted(os.listdir(input_path)):
        if not fname.endswith(".wav"):
            continue
        stem = fname[: -len(".wav")]
        lip = os.path.join(input_path, f"{stem}-lip.mp4")
        item = {
            "id": stem,
            "audio": os.path.join(input_path, fname),
            "lip_video": lip if os.path.exists(lip) else None,
        }
        if item["lip_video"] is None:
            for raw in (f"{stem}-video.mp4", f"{stem}.mp4"):
                p = os.path.join(input_path, raw)
                if os.path.exists(p):
                    item["video"] = p
                    break
        items.append(item)
    return items


def add_languages(out: List[Dict[str, Any]], items, transcriber, audio_max_length: int,
                  batch: int) -> None:
    """Each row's most likely language and its probability, a batch of
    ``batch`` clips at a time (the last padded with the first clip)."""
    import numpy as np

    from avsl_tpu_torch.data.audio_segments import load_wav
    from avsl_tpu_torch.decode.language import detect_language
    from avsl_tpu_torch.kernels.logmel import pad_or_trim

    clips = np.stack([
        pad_or_trim(np.asarray(load_wav(it["audio"]) if isinstance(it["audio"], str)
                               else it["audio"], np.float32), audio_max_length)
        for it in items
    ])
    for start in range(0, len(items), batch):
        idx = np.arange(start, min(start + batch, len(items)))
        pad = np.concatenate([idx, np.zeros(batch - len(idx), np.int64)])
        dets = detect_language(transcriber.model, transcriber.tokenizer, clips[pad])
        for j, i in enumerate(idx):
            best, table = dets[j]
            out[i]["language"] = best
            out[i]["language_prob"] = round(table[best], 4)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    from avsl_tpu_torch.core.config import FlamingoTrainConfig

    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="segment dir or CSV")
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--output", default=None)
    p.add_argument("--temperature_fallback", default="", help="comma list, e.g. 0.2,0.4")
    p.add_argument("--logprob_threshold", type=float, default=-1.0)
    p.add_argument("--word_timestamps", action="store_true")
    p.add_argument("--detect_language", action="store_true",
                   help="attach a per-item spoken-language posterior (decode/language.py); "
                   "needs float weights (no --quantize)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only int8 serving (models/quant.py)")
    p.add_argument("--kv_int8", action="store_true",
                   help="int8-compress the cross-attn/xv K/V the decode loop re-reads")
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

    from avsl_tpu_torch.cli._serving_common import build_transcriber

    items = collect_items(args.input)
    if not items:
        print("no items found")
        return []
    if args.detect_language and args.quantize:
        raise SystemExit("--detect_language needs float weights (no --quantize)")
    transcriber = build_transcriber(args, cfg)
    results = transcriber.transcribe(items)
    lead = transcriber.mesh is None or _rank() == 0
    out = [
        {"id": r.id, "text": r.text, "has_video": r.has_video,
         "avg_logprob": r.avg_logprob,
         **({"words": r.words} if r.words is not None else {})}
        for r in results
    ]
    if args.detect_language:
        add_languages(out, items, transcriber, int(cfg.audio_max_length), args.batch_size)
    if args.output and lead:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    if lead:
        for r in out[:10]:
            print(json.dumps(r))
    if transcriber.mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


def _rank() -> int:
    from avsl_tpu_torch.core.mesh import rank

    return rank()


if __name__ == "__main__":
    main()
