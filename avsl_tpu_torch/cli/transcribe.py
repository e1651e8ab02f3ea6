"""Batch transcription CLI of the port: directory of wavs -> transcripts JSON.

Usage: ``python -m avsl_tpu_torch.cli.transcribe --input <dir-or-csv>
[--config cfg.yaml] [--device cuda] [--output out.json] [--smoke]``

Port of ``avsl_tpu/cli/transcribe.py`` for the audio-only greedy path.
Without ``--config`` the model is the audio-only Whisper
(``add_gated_x_attn=0``); a config that asks for the gated video
cross-attention raises until slice 3. Weights are seeded random until
checkpoint restore is ported.
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
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)

    if args.config:
        cfg = FlamingoTrainConfig.from_yaml(args.config)
    else:
        cfg = FlamingoTrainConfig(add_gated_x_attn=0, use_av_hubert_encoder=False)
    if args.smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000

    from avsl_tpu_torch.cli._serving_common import build_transcriber

    items = collect_items(args.input)
    if not items:
        print("no items found")
        return []
    transcriber = build_transcriber(args, cfg)
    results = transcriber.transcribe(items)
    out = [
        {"id": r.id, "text": r.text, "has_video": r.has_video,
         "avg_logprob": r.avg_logprob}
        for r in results
    ]
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    for r in out[:10]:
        print(json.dumps(r))
    return out


if __name__ == "__main__":
    main()
