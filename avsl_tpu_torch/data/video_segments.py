"""Video segmentation (L2 video path).

Port of ``avsl_tpu/data/video_segments.py``. Parity with the reference's
preprocess/video_process.py:37-120: cut
per-segment clips from each source closeup video at 25 fps. The reference
shells out to ffmpeg per segment; here the native libav module (or cv2)
decodes the time window in-process and the clip is re-encoded with the
cv2 writer — one source handle, no subprocess per segment.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from avsl_tpu_torch.data.segments import Segment
from avsl_tpu_torch.data.video_io import write_video_frames


def cut_segment_frames(
    source_path: str, start: float, end: float, fps: int = 25,
    grayscale: bool = True,
) -> np.ndarray:
    """Decode frames of [start, end) seconds from a source video."""
    from avsl_tpu_torch.data import media_native as mn

    max_frames = max(int(np.ceil((end - start) * fps)) + 2, 1)
    if mn.native_available():
        frames = mn.decode_video_gray(
            source_path, max_frames=max_frames, start_sec=start, end_sec=end
        )
    else:  # cv2 fallback: seek by frame index
        import cv2

        cap = cv2.VideoCapture(source_path)
        src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(start * src_fps))
        out = []
        n = int((end - start) * src_fps)
        for _ in range(max(n, 1)):
            ok, frame = cap.read()
            if not ok:
                break
            out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        cap.release()
        if not out:
            raise IOError(f"no frames decoded from {source_path} [{start},{end})")
        frames = np.stack(out)
    return frames


def batch_segment_video(
    source_path: str,
    segments: Sequence[Segment],
    output_dir: str,
    fps: int = 25,
    overwrite: bool = False,
) -> List[Tuple[bool, str]]:
    """Cut every segment of one source video to
    ``{output_dir}/{segment_id}.mp4`` (25 fps grayscale)."""
    os.makedirs(output_dir, exist_ok=True)
    results: List[Tuple[bool, str]] = []
    for seg in segments:
        out = os.path.join(output_dir, f"{seg.segment_id}.mp4")
        try:
            if overwrite or not os.path.exists(out):
                frames = cut_segment_frames(source_path, seg.start, seg.end, fps)
                write_video_frames(out, frames, fps=fps)
            results.append((True, out))
        except Exception:
            results.append((False, out))
    return results
