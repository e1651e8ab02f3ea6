"""End-to-end AMI dataset construction drivers (L3).

Port of ``avsl_tpu/data/dataset_process.py``: the lip stage goes over the
port's ``RefinedMouthTracker`` (host) and ``extract_lip_clip``, whose warp
runs on the ``device`` passed in (``cuda`` unless the caller asks for the
CPU).

Parity with the reference's pipeline drivers:

* :func:`segment_sources` — the 5-step main pipeline
  (preprocess/dataset_process.py:399-543 in the reference): collect
  segments from transcript txts -> slice audio -> cut video -> extract
  lip-ROI clips -> build records -> package HF dataset.
* :func:`load_laughter_markers` / :func:`collect_marker_segments` /
  :func:`balance_classes` — the word-level laughter/disfluency dataset
  (laugh_dataset_process.py:45-170): punctuation filtered, NaN-safe,
  class-balanced by downsampling to the minority class, segment ids
  carrying the event type.
* :func:`process_marker_dataset` — media slicing for marker segments with
  skip-reason accounting and a minimum duration (dsfl_dataset_process.py:
  50-101), chunk/checkpoint-driven via avsl_tpu_torch.data.chunked.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from avsl_tpu_torch.data.audio_segments import batch_segment_audio
from avsl_tpu_torch.data.segments import Segment, collect_segments_from_transcripts
from avsl_tpu_torch.data.video_segments import batch_segment_video


# ---------------------------------------------------------------------------
# Main pipeline
# ---------------------------------------------------------------------------


def process_lip_videos(
    video_paths: Sequence[str],
    output_dir: str,
    detector=None,
    crop_size: int = 96,
    fps: int = 25,
    max_frames: int = 300,
    mean_face_path: Optional[str] = None,
    device: str = "cuda",
) -> List[Tuple[bool, str]]:
    """Extract 96x96 lip clips for each segment video
    (dataset_process.py:216-331 -> video_process.py:711).

    Default detector: refined mouth tracking — anchored NCC tracking plus
    image-measured lip-line/scale refinement (data/lip_refine.py). Golden
    test vs the reference's own dlib lip clip (tests/test_lip_roi.py):
    whole-clip mean NCC 0.87, early frames 0.82 (anchored tracking alone:
    0.61 / 0.54).

    ``mean_face_path``: warp against a mean-face .npy (e.g. the
    reference's resources/20words_mean_face.npy) instead of the
    parametric canonical face — bit-parity with reference-produced
    datasets (tests/test_mean_face.py pins the golden delta).

    Landmarks are tracked on the host; the warp and crop run on
    ``device``."""
    from avsl_tpu_torch.data.lip_refine import RefinedMouthTracker
    from avsl_tpu_torch.data.lip_roi import extract_lip_clip, resolve_mean_face
    from avsl_tpu_torch.data.video_io import read_video_frames, write_video_frames

    mean_face = resolve_mean_face(mean_face_path)
    # the default detector synthesizes landmarks in the SAME layout the
    # warp targets — mixing layouts shifts every crop (test_mean_face.py)
    detector = detector or RefinedMouthTracker(
        layout=mean_face if mean_face_path else None
    )
    os.makedirs(output_dir, exist_ok=True)
    results: List[Tuple[bool, str]] = []
    for path in video_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(output_dir, f"{name}-lip.mp4")
        try:
            if not os.path.exists(out):
                frames = read_video_frames(path, grayscale=True, max_frames=max_frames)
                lms = detector(frames)
                clip = extract_lip_clip(
                    frames, lms, mean_face=mean_face, crop_size=crop_size, device=device
                )
                if clip is None:
                    results.append((False, out))
                    continue
                write_video_frames(out, clip, fps=fps)
            results.append((True, out))
        except Exception:
            results.append((False, out))
    return results


def create_dataset_records(
    segments: Sequence[Segment],
    audio_dir: str,
    video_dir: Optional[str] = None,
    lip_dir: Optional[str] = None,
) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Build packaging records; returns (records, alignment_issue_ids) —
    segments whose media is partially missing (dataset_process.py:333-397)."""
    records, issues = [], []
    for seg in segments:
        sid = seg.segment_id
        rec: Dict[str, Any] = {
            "id": sid,
            "transcript": seg.transcript,
            "start": seg.start,
            "end": seg.end,
            "duration": seg.duration,
            "meeting_id": seg.meeting_id,
            "speaker_id": seg.speaker_id,
            "audio": os.path.join(audio_dir, f"{sid}.wav"),
        }
        ok = os.path.exists(rec["audio"])
        if video_dir is not None:
            rec["video"] = os.path.join(video_dir, f"{sid}.mp4")
            ok = ok and os.path.exists(rec["video"])
        if lip_dir is not None:
            rec["lip_video"] = os.path.join(lip_dir, f"{sid}-lip.mp4")
            ok = ok and os.path.exists(rec["lip_video"])
        records.append(rec)
        if not ok:
            issues.append(sid)
    return records, issues


def segment_sources(
    transcript_dir: str,
    audio_sources: Dict[Tuple[str, str], str],
    output_dir: str,
    video_sources: Optional[Dict[Tuple[str, str], str]] = None,
    extract_lips: bool = True,
    min_duration: float = 0.1,
    max_duration: Optional[float] = None,
    sample_rate: int = 16000,
    fps: int = 25,
    package_hf: bool = True,
    device: str = "cuda",
) -> Dict[str, Any]:
    """5-step pipeline: collect -> audio -> video -> lips -> records/HF.

    ``audio_sources`` / ``video_sources``: {(meeting, speaker): media path}.
    ``device`` runs the lip warp (only with ``video_sources``). With
    ``package_hf=False`` nothing here needs ``datasets``.
    """
    segments = collect_segments_from_transcripts(
        transcript_dir, min_duration=min_duration, max_duration=max_duration
    )
    by_source: Dict[Tuple[str, str], List[Segment]] = defaultdict(list)
    for s in segments:
        by_source[(s.meeting_id, s.speaker_id)].append(s)

    audio_dir = os.path.join(output_dir, "audio_segments")
    video_dir = os.path.join(output_dir, "video_segments")
    lip_dir = os.path.join(output_dir, "lip_videos")
    stats = {"segments": len(segments), "audio_ok": 0, "video_ok": 0, "lip_ok": 0}

    for key, segs in by_source.items():
        if key in audio_sources:
            res = batch_segment_audio(audio_sources[key], segs, audio_dir, sample_rate)
            stats["audio_ok"] += sum(ok for ok, _ in res)
        if video_sources and key in video_sources:
            res = batch_segment_video(video_sources[key], segs, video_dir, fps)
            stats["video_ok"] += sum(ok for ok, _ in res)

    if extract_lips and video_sources:
        vids = [
            os.path.join(video_dir, f"{s.segment_id}.mp4")
            for s in segments
            if os.path.exists(os.path.join(video_dir, f"{s.segment_id}.mp4"))
        ]
        res = process_lip_videos(vids, lip_dir, fps=fps, device=device)
        stats["lip_ok"] += sum(ok for ok, _ in res)

    records, issues = create_dataset_records(
        segments,
        audio_dir,
        video_dir if video_sources else None,
        lip_dir if (extract_lips and video_sources) else None,
    )
    stats["alignment_issues"] = len(issues)

    out: Dict[str, Any] = {"records": records, "stats": stats, "issues": issues}
    if package_hf:
        from avsl_tpu_torch.data.hf_dataset import av_to_hf_dataset

        issue_ids = set(issues)
        complete = [r for r in records if r["id"] not in issue_ids]
        if complete:
            ds = av_to_hf_dataset(
                complete, os.path.join(output_dir, "hf_dataset"), sample_rate
            )
            out["dataset"] = ds
    return out


# ---------------------------------------------------------------------------
# Build-from-existing-segments mode
# ---------------------------------------------------------------------------

# media filename suffixes: this framework's layout and the reference's
# (``-audio.wav`` / ``-video.mp4`` / ``-lip_video.mp4``,
# dataset_process.py:613-634) are both recognized when scanning.
_AUDIO_SUFFIXES = (".wav", "-audio.wav")
_VIDEO_SUFFIXES = (".mp4", "-video.mp4")
_LIP_SUFFIXES = ("-lip.mp4", "-lip_video.mp4")


def _scan_media_dir(directory: str, suffixes: Sequence[str]) -> Dict[str, str]:
    """{segment_id: path} for files matching any suffix (longest wins)."""
    out: Dict[str, str] = {}
    if not os.path.isdir(directory):
        return out
    ordered = sorted(suffixes, key=len, reverse=True)
    for fname in sorted(os.listdir(directory)):
        for suf in ordered:
            if fname.endswith(suf):
                out[fname[: -len(suf)]] = os.path.join(directory, fname)
                break
    return out


def dataset_from_existing_segments(
    source_dir: str,
    transcript_dir: str,
    output_dir: str,
    include_lips: bool = False,
    min_duration: float = 0.1,
    package_hf: bool = True,
    sample_rate: int = 16000,
) -> Dict[str, Any]:
    """Rebuild dataset records from ALREADY-SLICED media — no re-segmenting.

    The reference's recovery/iteration workflow
    (``ami_dataset_from_existing_segments``, dataset_process.py:549-749):
    scan ``{source_dir}/audio_segments`` and ``{source_dir}/video_segments``
    (plus ``original_videos``/``lips`` reference sublayouts and this
    framework's ``lip_videos``), join with transcripts by segment id
    (``meeting-speaker-start-end``), keep every segment that has at least
    one media stream, record ``has_*`` flags, write
    ``dataset_records.json``, and optionally package the HF dataset."""
    audio_dir = os.path.join(source_dir, "audio_segments")
    video_dir = os.path.join(source_dir, "video_segments")
    audio_files = _scan_media_dir(audio_dir, _AUDIO_SUFFIXES)
    video_files = _scan_media_dir(video_dir, _VIDEO_SUFFIXES)
    if not video_files:  # reference nests originals one level down
        video_files = _scan_media_dir(
            os.path.join(video_dir, "original_videos"), _VIDEO_SUFFIXES
        )
    lip_files: Dict[str, str] = {}
    if include_lips:
        for cand in (os.path.join(output_dir, "lip_videos"),
                     os.path.join(source_dir, "lip_videos"),
                     os.path.join(video_dir, "lips")):
            lip_files = _scan_media_dir(cand, _LIP_SUFFIXES)
            if lip_files:
                break

    segments = collect_segments_from_transcripts(
        transcript_dir, min_duration=min_duration
    )
    transcript_info = {s.segment_id: s for s in segments}

    records: List[Dict[str, Any]] = []
    bad_ids: List[str] = []
    all_ids = set(audio_files) | set(video_files) | set(transcript_info)
    for sid in sorted(all_ids):
        has_audio = sid in audio_files
        has_video = sid in video_files
        if not (has_audio or has_video):
            continue
        parts = sid.split("-")
        try:
            float(parts[-2]), float(parts[-1])
        except (ValueError, IndexError):
            # stray non-segment file in the media dirs: skip, don't abort
            bad_ids.append(sid)
            continue
        if len(parts) < 4:
            bad_ids.append(sid)
            continue
        seg = transcript_info.get(sid)
        rec: Dict[str, Any] = {
            "id": sid,
            "meeting_id": parts[0],
            "speaker_id": parts[1],
            "start": float(parts[-2]),
            "end": float(parts[-1]),
            "duration": float(parts[-1]) - float(parts[-2]),
            "transcript": seg.transcript if seg else "",
            "has_audio": has_audio,
            "has_video": has_video,
            "has_lip_video": sid in lip_files,
            "has_transcript": seg is not None,
        }
        if has_audio:
            rec["audio"] = audio_files[sid]
        if has_video:
            rec["video"] = video_files[sid]
        if sid in lip_files:
            rec["lip_video"] = lip_files[sid]
        records.append(rec)

    os.makedirs(output_dir, exist_ok=True)
    import json

    with open(os.path.join(output_dir, "dataset_records.json"), "w") as f:
        json.dump(records, f)

    out: Dict[str, Any] = {
        "records": records,
        "stats": {
            "audio_files": len(audio_files),
            "video_files": len(video_files),
            "lip_files": len(lip_files),
            "transcripts": len(transcript_info),
            "records": len(records),
            "skipped_bad_ids": len(bad_ids),
        },
    }
    if package_hf and records:
        from avsl_tpu_torch.data.hf_dataset import av_to_hf_dataset

        out["dataset"] = av_to_hf_dataset(
            records, os.path.join(output_dir, "hf_dataset"), sample_rate
        )
    return out


def reprocess_lips_from_csv(
    csv_path: str,
    lip_dir: str,
    only_missing: bool = False,
    detector=None,
    update_csv: bool = True,
    results_json: Optional[str] = None,
    mean_face_path: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """CSV-driven lip (re)processing — the reference's ``process_lip`` /
    ``process_lip_chunk`` modes (dataset_process.py:753-1079).

    Reads a segments-info CSV (``id`` + ``video`` columns; ``has_video`` /
    ``has_lip_video`` honored when present), re-extracts the 96x96 lip clip
    for each row with a video (or, with ``only_missing=True``, only rows
    whose lip clip is absent), writes a per-segment results JSON, and
    merges ``has_lip_video``/``lip_video`` back into the CSV in place."""
    import json

    import pandas as pd

    df = pd.read_csv(csv_path)
    if "video" not in df.columns:
        raise ValueError(f"{csv_path} has no 'video' column")

    def truthy(col):
        # CSV round-trips turn bool columns with blanks into object dtype
        # where astype(bool) maps both NaN and the string "False" to True
        return col.map(
            lambda v: (not pd.isna(v))
            and str(v).strip().lower() in ("true", "1", "1.0", "yes")
        )

    rows = df
    if "has_video" in df.columns:
        rows = rows[truthy(rows["has_video"])]
    rows = rows.dropna(subset=["video"])
    if only_missing and "has_lip_video" in df.columns:
        rows = rows[~truthy(rows["has_lip_video"])]

    results: Dict[str, Tuple[bool, str]] = {}
    missing_files = 0
    todo: List[Tuple[str, str]] = []
    for row in rows.to_dict("records"):
        if not os.path.exists(str(row["video"])):
            missing_files += 1
            continue
        todo.append((str(row["id"]), str(row["video"])))

    os.makedirs(lip_dir, exist_ok=True)
    res = process_lip_videos(
        [v for _, v in todo], lip_dir, detector=detector,
        mean_face_path=mean_face_path, device=device,
    )
    for (sid, _), (ok, out_path) in zip(todo, res):
        results[sid] = (ok, out_path)

    if results_json is None:
        results_json = os.path.join(lip_dir, "lip_segment_results.json")
    with open(results_json, "w") as f:
        json.dump(
            {sid: {"success": ok, "output_file": p} for sid, (ok, p) in results.items()},
            f, indent=2,
        )

    if update_csv:
        if "has_lip_video" not in df.columns:
            df["has_lip_video"] = False
        if "lip_video" not in df.columns:
            df["lip_video"] = None
        # compare as strings: pandas may read numeric ids as int64 and a
        # string==int comparison is all-False (zero rows updated, no error)
        ids_str = df["id"].astype(str)
        for sid, (ok, path) in results.items():
            sel = ids_str == str(sid)
            df.loc[sel, "has_lip_video"] = bool(ok)
            df.loc[sel, "lip_video"] = path if ok else None
        df.to_csv(csv_path, index=False)

    n_ok = sum(ok for ok, _ in results.values())
    return {
        "results": results,
        "n_ok": n_ok,
        "n_failed": len(results) - n_ok,
        "missing_files": missing_files,
    }


# ---------------------------------------------------------------------------
# Word-level laughter / disfluency datasets
# ---------------------------------------------------------------------------


def load_laughter_markers(csv_path: str, drop_punctuation: bool = True):
    """Load ami_laugh_markers.csv with NaN/None handling and punctuation
    filtering (laugh_dataset_process.py:45-75)."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    df = df.dropna(subset=["start_time", "end_time", "word"])
    df["start_time"] = df["start_time"].astype(float)
    df["end_time"] = df["end_time"].astype(float)
    if drop_punctuation:
        punct = set(".,!?;:…‚—-'\"`")
        df = df[~df["word"].astype(str).str.strip().isin(punct)]
    return df.reset_index(drop=True)


def sanitize_filename(label: str) -> str:
    """Replace filesystem-hostile characters with '_'
    (dsfl_dataset_process.py:116: event labels like 'uh-huh?' become
    part of segment filenames)."""
    return re.sub(r'[\\/*?:"<>|]', "_", label)


def marker_segment_id(
    meeting: str, speaker: str, start: float, end: float, event_type: str
) -> str:
    """Segment id carrying the (filename-sanitized) event type
    (laugh_dataset_process.py:89-107; dsfl_dataset_process.py:116)."""
    return f"{meeting}-{speaker}-{sanitize_filename(event_type)}-{start:.2f}-{end:.2f}"


def collect_marker_segments(
    df,
    min_duration: float = 0.05,
    laugh_types: Sequence[str] = ("laughter",),
    speakers: Optional[Sequence[str]] = None,
) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
    """Marker rows -> per-word segments with per-reason skip accounting.

    Returns (segments, skip_reasons). Each segment dict carries
    meeting/speaker/word/start/end/event_type ('laughter' vs the
    disfluency type vs 'fluent'). Skip reasons mirror the reference's dsfl
    counters (dsfl_dataset_process.py:50-53): ``speaker_mapping`` (when a
    ``speakers`` allowlist is given), ``too_short``, ``bad_times``."""
    skip = {"too_short": 0, "bad_times": 0, "speaker_mapping": 0}
    out: List[Dict[str, Any]] = []
    seen_ids: Dict[str, int] = {}
    for row in df.itertuples(index=False):
        if speakers is not None and str(row.speaker_id) not in speakers:
            skip["speaker_mapping"] += 1
            continue
        start, end = float(row.start_time), float(row.end_time)
        if not np.isfinite(start) or not np.isfinite(end) or end <= start:
            skip["bad_times"] += 1
            continue
        if end - start < min_duration:
            skip["too_short"] += 1
            continue
        event = str(row.disfluency_type)
        sid = marker_segment_id(row.meeting_id, row.speaker_id, start, end, event)
        # centisecond rounding can collide for overlapping annotations of
        # the same speaker+type; a duplicate id would share one wav and
        # double-count in the stats/balancing — disambiguate in order
        if sid in seen_ids:
            seen_ids[sid] += 1
            sid = f"{sid}-{seen_ids[sid]}"
        else:
            seen_ids[sid] = 1
        out.append(
            {
                "id": sid,
                "meeting_id": row.meeting_id,
                "speaker_id": row.speaker_id,
                "word": row.word,
                "start": start,
                "end": end,
                "duration": end - start,
                "event_type": "laughter" if event in laugh_types else event,
            }
        )
    return out, skip


def balance_classes(
    segments: Sequence[Dict[str, Any]],
    label_key: str = "event_type",
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """Downsample every class to the minority class count
    (laugh_dataset_process.py:76-84)."""
    rng = np.random.default_rng(seed)
    by_label: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for s in segments:
        by_label[s[label_key]].append(s)
    n_min = min(len(v) for v in by_label.values())
    out: List[Dict[str, Any]] = []
    for label, items in sorted(by_label.items()):
        idx = rng.permutation(len(items))[:n_min]
        out.extend(items[i] for i in sorted(idx))
    return out


class _MarkerSeg:
    """Shim giving a marker dict the (segment_id, start, end) surface the
    media slicers consume — marker ids carry the event type
    (laugh_dataset_process.py:89-107), so plain Segment ids don't fit."""

    def __init__(self, d: Dict[str, Any]):
        self.segment_id = d["id"]
        self.start = d["start"]
        self.end = d["end"]


def process_marker_dataset(
    df,
    audio_sources: Dict[Tuple[str, str], str],
    output_dir: str,
    video_sources: Optional[Dict[Tuple[str, str], str]] = None,
    min_duration: float = 0.05,
    balance: bool = True,
    sample_rate: int = 16000,
    fps: int = 25,
    speakers: Optional[Sequence[str]] = None,
    stats_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Word-level marker segments -> sliced media + per-type stats JSON.

    The driver the reference spreads over laugh_dataset_process.py:508-693
    and dsfl_dataset_process.py:260-490: collect marker segments with
    per-reason skip accounting, drop segments whose source media is absent
    (``source_missing`` counter, dsfl_dataset_process.py:94), optionally
    class-balance by downsampling, slice audio (and video when sources are
    given), and write a stats JSON with per-event-type counts and all skip
    reasons (laugh_dataset_process.py:296-309 observability)."""
    import json

    segments, skip = collect_marker_segments(
        df, min_duration=min_duration, speakers=speakers
    )
    kept: List[Dict[str, Any]] = []
    skip["source_missing"] = 0
    for s in segments:
        key = (s["meeting_id"], s["speaker_id"])
        if key not in audio_sources and not (video_sources and key in video_sources):
            skip["source_missing"] += 1
            continue
        kept.append(s)
    if balance and kept:
        kept = balance_classes(kept)

    audio_dir = os.path.join(output_dir, "audio_segments")
    video_dir = os.path.join(output_dir, "video_segments")
    n_audio_ok = n_video_ok = 0
    for key, segs in group_segments_by_source(kept).items():
        shims = [_MarkerSeg(s) for s in segs]
        if key in audio_sources:
            res = batch_segment_audio(audio_sources[key], shims, audio_dir, sample_rate)
            for s, (ok, path) in zip(segs, res):
                if ok:
                    s["audio"] = path
                    n_audio_ok += 1
        if video_sources and key in video_sources:
            res = batch_segment_video(video_sources[key], shims, video_dir, fps)
            for s, (ok, path) in zip(segs, res):
                if ok:
                    s["video"] = path
                    n_video_ok += 1

    per_type: Dict[str, int] = defaultdict(int)
    for s in kept:
        per_type[s["event_type"]] += 1
    stats = {
        "total_markers": int(len(df)),
        "segments_kept": len(kept),
        "audio_ok": n_audio_ok,
        "video_ok": n_video_ok,
        "per_event_type": dict(sorted(per_type.items())),
        "skipped": dict(skip),
        "balanced": bool(balance),
    }
    os.makedirs(output_dir, exist_ok=True)
    stats_path = stats_path or os.path.join(output_dir, "marker_dataset_stats.json")
    with open(stats_path, "w") as f:
        json.dump(stats, f, indent=2)
    return {"segments": kept, "stats": stats, "stats_path": stats_path}


def load_ami_segments_csv(csv_path: str, base_dir: str = ""):
    """Load an ``ami-segments-info.csv`` (columns with ``_abs`` absolute
    media paths, reference preprocess/ami_clean_dataset_process.py:19-68)
    into packaging records."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    records: List[Dict[str, Any]] = []
    for row in df.to_dict("records"):
        rec: Dict[str, Any] = {}
        for key, val in row.items():
            if key.endswith("_abs"):
                media = key[: -len("_abs")]
                rec[media] = (
                    os.path.join(base_dir, str(val)) if base_dir else str(val)
                )
            else:
                rec[key] = val
        rec.setdefault("id", rec.get("segment_id", ""))
        records.append(rec)
    return records


def process_ami_segments_dataset(
    csv_path: str,
    output_dir: str,
    base_dir: str = "",
    check_videos: bool = True,
    sample_rate: int = 16000,
):
    """CSV -> validated HF dataset (ami_clean_dataset_process.py:141)."""
    from avsl_tpu_torch.data.hf_dataset import av_to_hf_dataset

    records = load_ami_segments_csv(csv_path, base_dir)
    return av_to_hf_dataset(
        records, output_dir, sample_rate=sample_rate, check_videos=check_videos
    )


def group_segments_by_source(
    segments: Sequence[Dict[str, Any]]
) -> Dict[Tuple[str, str], List[Dict[str, Any]]]:
    by_source: Dict[Tuple[str, str], List[Dict[str, Any]]] = defaultdict(list)
    for s in segments:
        by_source[(s["meeting_id"], s["speaker_id"])].append(s)
    return by_source
