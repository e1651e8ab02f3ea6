"""Long-form transcription: media of any length through the fixed batch.

Port of ``avsl_tpu/infer/longform.py``. A long signal is cut on the host
into windows of at most ``audio_max_length`` samples, each cut at the
centre of the quietest 25 ms frame of a trailing search region, so cuts
land in pauses and windows are transcribed independently (no overlap, no
text carried from one window to the next). Windows are ordinary batch
items, so windows of different requests share the serving daemon's
batches. A ``lip_video`` clip is decoded once and each window gets its
frame range ``[round(start/sr*fps), round(end/sr*fps))`` as ``lip_feats``.
Raw closeups are refused (each window would re-run the lip detection).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from avsl_tpu_torch.data.audio_segments import load_wav
from avsl_tpu_torch.data.video_io import load_video_feats


@dataclass
class LongSegment:
    start_s: float
    end_s: float
    text: str
    # the window's decode confidence (mean token log-probability or beam score)
    avg_logprob: float = 0.0
    # word timestamps in the stream's time (window offset applied)
    words: Optional[List[dict]] = None


@dataclass
class LongFormResult:
    id: str
    text: str
    segments: List[LongSegment]
    has_video: bool


def energy_cut_points(
    audio: np.ndarray,
    window_samples: int,
    sample_rate: int = 16000,
    search_s: float = 2.0,
    frame_ms: float = 25.0,
) -> List[Tuple[int, int]]:
    """Spans of at most ``window_samples`` that tile ``audio`` exactly: each
    nominal boundary moves back to the centre of the minimum-RMS frame in
    the trailing ``search_s`` (never below half a window, so every span
    makes progress)."""
    n = int(len(audio))
    if window_samples <= 0:
        raise ValueError(f"window_samples {window_samples} must be positive")
    if n <= window_samples:
        return [(0, n)]
    frame = max(int(sample_rate * frame_ms / 1000.0), 1)
    search = max(int(sample_rate * search_s), frame)
    spans: List[Tuple[int, int]] = []
    pos = 0
    while n - pos > window_samples:
        nominal = pos + window_samples
        lo = max(pos + window_samples // 2, nominal - search)
        region = np.asarray(audio[lo:nominal], np.float32)
        k = (len(region) // frame) * frame
        if k >= frame:
            rms = np.sqrt(np.mean(region[:k].reshape(-1, frame) ** 2, axis=1))
            cut = lo + int(np.argmin(rms)) * frame + frame // 2
        else:  # a region shorter than one frame
            cut = nominal
        cut = int(min(max(cut, pos + 1), nominal))
        spans.append((pos, cut))
        pos = cut
    spans.append((pos, n))
    return spans


def split_item(
    item: Dict[str, Any],
    audio_max_length: int,
    video_frames: int,
    crop: int = 88,
    sample_rate: int = 16000,
    fps: int = 25,
    search_s: float = 2.0,
) -> Tuple[List[Dict[str, Any]], List[Tuple[float, float]]]:
    """One long item -> (window items with ids ``{id}#w{k}``, each window's
    (start_s, end_s)). Host work only (the wav, the energy scan, one clip
    decode): safe on a request handler thread."""
    if item.get("video") and not item.get("lip_video"):
        raise ValueError(
            "long-form supports 'lip_video' (an extracted lip clip) or audio-only; "
            "raw-closeup windows would re-run detection per window — pre-extract "
            "the lip clip instead")
    audio = item["audio"]
    audio = load_wav(audio) if isinstance(audio, str) else np.asarray(audio, np.float32)
    spans = energy_cut_points(audio, audio_max_length, sample_rate=sample_rate,
                              search_s=search_s)
    lip_feats: Optional[np.ndarray] = None
    if item.get("lip_video"):
        lip_feats = load_video_feats(item["lip_video"], image_crop_size=crop)

    base_id = str(item.get("id", ""))
    windows: List[Dict[str, Any]] = []
    for k, (s, e) in enumerate(spans):
        w: Dict[str, Any] = {"id": f"{base_id}#w{k}", "audio": audio[s:e]}
        if lip_feats is not None:
            fs = int(round(s / sample_rate * fps))
            fe = int(round(e / sample_rate * fps))
            seg = lip_feats[fs:fe][:video_frames]
            if len(seg):
                w["lip_feats"] = seg
        windows.append(w)
    return windows, [(s / sample_rate, e / sample_rate) for s, e in spans]


def shift_words(words: Optional[List[dict]], offset_s: float) -> Optional[List[dict]]:
    """Window-relative word times -> the stream's time."""
    if words is None:
        return None
    return [{**w, "start_s": round(w["start_s"] + offset_s, 3),
             "end_s": round(w["end_s"] + offset_s, 3)} for w in words]


def stitch(item_id: str, window_results: Sequence[Any],
           spans_s: Sequence[Tuple[float, float]]) -> LongFormResult:
    """Window results (in order) -> one :class:`LongFormResult`: texts
    joined with single spaces, each window a segment with its times."""
    segments = [
        LongSegment(start_s=round(s, 3), end_s=round(e, 3), text=r.text,
                    avg_logprob=getattr(r, "avg_logprob", 0.0),
                    words=shift_words(getattr(r, "words", None), s))
        for r, (s, e) in zip(window_results, spans_s)
    ]
    return LongFormResult(
        id=item_id,
        text=" ".join(seg.text for seg in segments if seg.text),
        segments=segments,
        has_video=any(r.has_video for r in window_results),
    )
