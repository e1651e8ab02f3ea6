"""AMI preprocessing CLI.

Port of ``avsl_tpu/cli/preprocess.py``, with every subcommand of its
``main``. Subcommands mirror the reference's preprocessing entry points
(its preprocess/*.py __main__ blocks):

* ``transcripts``   — NITE XML -> per-speaker ``[start-end] text`` files
* ``markers``       — words+disfluency XML -> ami_laugh_markers.csv
* ``dialogue_acts`` — DA/AP XML -> three CSVs
* ``segment``       — transcripts + media -> audio/video/lip segments + HF dataset
* ``lips``          — lip-ROI extraction over a directory/CSV of videos,
                      chunked with checkpoint resume
* ``segment_exist``, ``reprocess_lips``, ``marker_dataset`` — datasets from
                      sliced media, CSV-driven lip re-extraction, and the
                      word-level laughter/disfluency dataset

``segment``, ``lips`` and ``reprocess_lips`` take ``--device`` (default
``cuda``) for the lip warp; landmarks are tracked on the host.

Usage: ``python -m avsl_tpu_torch.cli.preprocess <subcommand> [flags]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def cmd_transcripts(args) -> None:
    from avsl_tpu_torch.data.ami_xml import process_transcripts

    written = process_transcripts(args.input, args.output)
    print(f"wrote {len(written)} transcript files to {args.output}")


def cmd_markers(args) -> None:
    from avsl_tpu_torch.data.ami_xml import disfluency_laughter_to_csv

    path = disfluency_laughter_to_csv(
        args.input,
        args.output,
        disfluency_dir=args.disfluency_dir,
        dsfl_types_file=args.dsfl_types,
        include_fluent=args.include_fluent,
        strict_reference=args.strict_reference,
    )
    print(f"wrote {path}")


def cmd_dialogue_acts(args) -> None:
    from avsl_tpu_torch.data.ami_xml import dialogue_acts_to_csv

    out = dialogue_acts_to_csv(
        args.input,
        args.output,
        dialogue_acts_dir=args.da_dir,
        da_types_file=args.da_types,
        ap_types_file=args.ap_types,
    )
    print(json.dumps(out, indent=2))


def cmd_segment(args) -> None:
    from avsl_tpu_torch.data.ami_xml import AMI_SPEAKERS
    from avsl_tpu_torch.data.dataset_process import segment_sources

    audio_sources, video_sources = {}, {}
    for fname in sorted(os.listdir(args.media_dir)):
        # media naming: {meeting}.{channel}.{wav|mp4|avi}
        parts = fname.split(".")
        if len(parts) < 3:
            continue
        meeting, channel = parts[0], parts[1]
        for speaker, chans in AMI_SPEAKERS.items():
            path = os.path.join(args.media_dir, fname)
            if channel == chans["audio"]:
                audio_sources[(meeting, speaker)] = path
            elif channel == chans["video"]:
                video_sources[(meeting, speaker)] = path
    out = segment_sources(
        args.transcripts,
        audio_sources,
        args.output,
        video_sources=video_sources or None,
        extract_lips=not args.no_lips,
        min_duration=args.min_duration,
        max_duration=args.max_duration,
        device=args.device,
    )
    print(json.dumps(out["stats"], indent=2))


def cmd_segment_exist(args) -> None:
    """Build the HF dataset from already-sliced media (the reference's
    ``--mode segment_exist``, dataset_process.py:549-749)."""
    from avsl_tpu_torch.data.dataset_process import dataset_from_existing_segments

    out = dataset_from_existing_segments(
        args.source_dir,
        args.transcripts,
        args.output,
        include_lips=args.include_lips,
        min_duration=args.min_duration,
        package_hf=not args.no_dataset,
    )
    print(json.dumps(out["stats"], indent=2))


def cmd_reprocess_lips(args) -> None:
    """CSV-driven lip reprocessing (the reference's ``--mode process_lip``
    / ``process_lip_chunk``, dataset_process.py:753-1079)."""
    from avsl_tpu_torch.data.dataset_process import reprocess_lips_from_csv

    out = reprocess_lips_from_csv(
        args.csv,
        args.output,
        only_missing=args.only_missing,
        update_csv=not args.no_update_csv,
        device=args.device,
    )
    print(json.dumps({"n_ok": out["n_ok"], "n_failed": out["n_failed"],
                      "missing_files": out["missing_files"]}))


def cmd_marker_dataset(args) -> None:
    """Word-level laughter/disfluency dataset with media slicing + stats
    (laugh_dataset_process.py / dsfl_dataset_process.py drivers)."""
    from avsl_tpu_torch.data.ami_xml import AMI_SPEAKERS
    from avsl_tpu_torch.data.dataset_process import (
        load_laughter_markers,
        process_marker_dataset,
    )

    df = load_laughter_markers(args.csv)
    audio_sources, video_sources = {}, {}
    if args.media_dir:
        for fname in sorted(os.listdir(args.media_dir)):
            parts = fname.split(".")
            if len(parts) < 3:
                continue
            meeting, channel = parts[0], parts[1]
            for speaker, chans in AMI_SPEAKERS.items():
                path = os.path.join(args.media_dir, fname)
                if channel == chans["audio"]:
                    audio_sources[(meeting, speaker)] = path
                elif channel == chans["video"]:
                    video_sources[(meeting, speaker)] = path
    out = process_marker_dataset(
        df, audio_sources, args.output,
        video_sources=video_sources or None,
        min_duration=args.min_duration,
        balance=not args.no_balance,
        speakers=sorted(AMI_SPEAKERS) if args.check_speakers else None,
    )
    print(json.dumps(out["stats"], indent=2))


def cmd_lips(args) -> None:
    from avsl_tpu_torch.data.chunked import process_in_chunks
    from avsl_tpu_torch.data.dataset_process import process_lip_videos

    videos: List[str] = []
    if os.path.isdir(args.input):
        videos = [
            os.path.join(args.input, f)
            for f in sorted(os.listdir(args.input))
            if f.endswith((".mp4", ".avi"))
        ]
    elif args.input.endswith(".csv"):
        import pandas as pd

        videos = pd.read_csv(args.input)[args.csv_column].dropna().tolist()
    if not videos:
        print("no videos found")
        return

    def work(path):
        res = process_lip_videos(
            [path], args.output,
            mean_face_path=getattr(args, "mean_face_path", None),
            device=args.device,
        )
        return res[0]

    out = process_in_chunks(
        videos, work, os.path.join(args.output, "_checkpoints"),
        chunk_size=args.chunk_size, resume=not args.no_resume,
    )
    print(json.dumps({"n_ok": out["n_ok"], "n_failed": out["n_failed"],
                      "resumed_from": out["resumed_from"]}))


_DEVICE_HELP = "where the lip warp runs (cuda, or cpu)"


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="avsl_tpu_torch.preprocess")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("transcripts")
    t.add_argument("--input", required=True)
    t.add_argument("--output", required=True)

    m = sub.add_parser("markers")
    m.add_argument("--input", required=True)
    m.add_argument("--output", required=True)
    m.add_argument("--disfluency_dir", default=None)
    m.add_argument("--dsfl_types", default=None)
    m.add_argument("--include_fluent", action="store_true")
    m.add_argument(
        "--strict_reference", action="store_true",
        help="bit-parity row set with reference-built marker CSVs "
             "(drops un-annotated laughs; no punctuation filter)",
    )

    d = sub.add_parser("dialogue_acts")
    d.add_argument("--input", required=True)
    d.add_argument("--output", required=True)
    d.add_argument("--da_dir", default=None)
    d.add_argument("--da_types", default=None)
    d.add_argument("--ap_types", default=None)

    s = sub.add_parser("segment")
    s.add_argument("--transcripts", required=True)
    s.add_argument("--media_dir", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--no_lips", action="store_true")
    s.add_argument("--min_duration", type=float, default=0.1)
    s.add_argument("--max_duration", type=float, default=None)
    s.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    l = sub.add_parser("lips")
    l.add_argument("--input", required=True, help="video dir or CSV")
    l.add_argument("--output", required=True)
    l.add_argument("--csv_column", default="video")
    l.add_argument("--chunk_size", type=int, default=100)
    l.add_argument("--no_resume", action="store_true")
    l.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    l.add_argument(
        "--mean_face_path", default=None,
        help="warp against this mean-face .npy (e.g. the reference's "
             "resources/20words_mean_face.npy) instead of the parametric "
             "canonical face",
    )

    se = sub.add_parser("segment_exist",
                        help="build HF dataset from already-sliced media")
    se.add_argument("--source_dir", required=True)
    se.add_argument("--transcripts", required=True)
    se.add_argument("--output", required=True)
    se.add_argument("--include_lips", action="store_true")
    se.add_argument("--min_duration", type=float, default=0.1)
    se.add_argument("--no_dataset", action="store_true")

    rl = sub.add_parser("reprocess_lips",
                        help="CSV-driven lip (re)extraction + CSV merge")
    rl.add_argument("--csv", required=True)
    rl.add_argument("--output", required=True)
    rl.add_argument("--only_missing", action="store_true")
    rl.add_argument("--no_update_csv", action="store_true")
    rl.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    md = sub.add_parser("marker_dataset",
                        help="laughter/disfluency word dataset + stats JSON")
    md.add_argument("--csv", required=True)
    md.add_argument("--output", required=True)
    md.add_argument("--media_dir", default=None)
    md.add_argument("--min_duration", type=float, default=0.05)
    md.add_argument("--no_balance", action="store_true")
    md.add_argument("--check_speakers", action="store_true")

    args = p.parse_args(argv)
    {
        "transcripts": cmd_transcripts,
        "markers": cmd_markers,
        "dialogue_acts": cmd_dialogue_acts,
        "segment": cmd_segment,
        "lips": cmd_lips,
        "segment_exist": cmd_segment_exist,
        "reprocess_lips": cmd_reprocess_lips,
        "marker_dataset": cmd_marker_dataset,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
