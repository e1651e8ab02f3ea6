"""Segment collection from transcript txt files (L3 entry).

A copy of ``avsl_tpu/data/segments.py``.

Parity with the reference's collection step
(preprocess/dataset_process.py:63-157): parse ``[start-end] text`` lines,
skip segments shorter than ``min_duration`` (0.1 s default, :126-128),
derive per-speaker media channels from AMI_SPEAKERS, and build segment ids
``{meeting}-{speaker}-{start}-{end}`` (:135)."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from avsl_tpu_torch.data.ami_xml import AMI_SPEAKERS

_LINE_RE = re.compile(r"^\[([\d.]+)-([\d.]+)\]\s+(.*)$")


@dataclass
class Segment:
    meeting_id: str
    speaker_id: str
    start: float
    end: float
    transcript: str
    audio_channel: str = ""
    video_channel: str = ""

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def segment_id(self) -> str:
        return segment_id(self.meeting_id, self.speaker_id, self.start, self.end)


def segment_id(meeting: str, speaker: str, start: float, end: float) -> str:
    return f"{meeting}-{speaker}-{start:.2f}-{end:.2f}"


def parse_transcript_line(line: str) -> Optional[tuple]:
    m = _LINE_RE.match(line.strip())
    if not m:
        return None
    return float(m.group(1)), float(m.group(2)), m.group(3)


def collect_segments_from_transcripts(
    transcript_dir: str,
    min_duration: float = 0.1,
    max_duration: Optional[float] = None,
) -> List[Segment]:
    """Read all ``{meeting}-{speaker}.txt`` files into Segment records."""
    segments: List[Segment] = []
    if not os.path.isdir(transcript_dir):
        return segments
    fname_re = re.compile(r"([^-]+)-([^-.]+)\.txt$")
    for fname in sorted(os.listdir(transcript_dir)):
        m = fname_re.match(fname)
        if not m:
            continue
        meeting, speaker = m.groups()
        channels = AMI_SPEAKERS.get(speaker, {"audio": "", "video": ""})
        with open(os.path.join(transcript_dir, fname), encoding="utf-8") as f:
            for line in f:
                parsed = parse_transcript_line(line)
                if parsed is None:
                    continue
                start, end, text = parsed
                if end - start < min_duration:
                    continue
                if max_duration is not None and end - start > max_duration:
                    continue
                if not text.strip():
                    continue
                segments.append(
                    Segment(
                        meeting_id=meeting,
                        speaker_id=speaker,
                        start=start,
                        end=end,
                        transcript=text.strip(),
                        audio_channel=channels["audio"],
                        video_channel=channels["video"],
                    )
                )
    return segments
