"""Host video decoding and the runtime lip-feature loader.

A copy of ``read_video_frames``, ``write_video_frames``,
``load_video_feats``, ``trim_video_to_audio`` and the source resolver they
use from ``avsl_tpu/data/video_io.py``: decode with OpenCV
-> ITU-R 601 grayscale -> [0, 1] -> centre crop (resized up when smaller)
-> (x - 0.421) / 0.165 -> [T, crop, crop, 1] float32. ``cv2`` is imported
inside the functions that decode, so importing this module (and serving
``lip_feats`` arrays) needs no OpenCV.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Optional

import numpy as np

# attributes under which reader-like objects keep their file path
_PATH_ATTRS = ("_filename", "filename", "path", "_path", "file_path", "source")


@contextlib.contextmanager
def video_source_path(src: Any):
    """Yield a filesystem path for a video source: a path, raw bytes
    (spooled to a temporary file that lives for the ``with`` body), a
    record dict with "bytes" or "path", or a reader-like object with a
    path attribute."""
    if isinstance(src, (str, os.PathLike)):
        yield os.fspath(src)
        return
    if isinstance(src, dict):
        data = src.get("bytes")
        if data:
            with video_source_path(bytes(data)) as p:
                yield p
            return
        path = src.get("path")
        if path:
            yield str(path)
            return
        raise IOError(f"video record dict has neither bytes nor path: {sorted(src)}")
    if isinstance(src, (bytes, bytearray, memoryview)):
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        try:
            tmp.write(bytes(src))
            tmp.close()
            yield tmp.name
        finally:
            os.unlink(tmp.name)
        return
    for attr in _PATH_ATTRS:
        path = getattr(src, attr, None)
        if path and isinstance(path, (str, os.PathLike)) and os.path.exists(os.fspath(path)):
            yield os.fspath(path)
            return
    raise IOError(f"cannot resolve video source of type {type(src)!r}")


def read_video_frames(
    path: Any, grayscale: bool = True, max_frames: Optional[int] = None
) -> np.ndarray:
    """Decode a video source (see :func:`video_source_path`) to [T, H, W]
    (gray) or [T, H, W, 3] (BGR -> RGB) uint8."""
    import cv2

    if not isinstance(path, (str, os.PathLike)):
        with video_source_path(path) as p:
            return read_video_frames(p, grayscale, max_frames)
    cap = cv2.VideoCapture(os.fspath(path))
    if not cap.isOpened():
        raise IOError(f"Cannot open video {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if grayscale:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        else:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise IOError(f"No frames decoded from {path}")
    return np.stack(frames)


def write_video_frames(path: str, frames: np.ndarray, fps: int = 25) -> str:
    """Write [T, H, W] (gray) or [T, H, W, 3] uint8 frames to an mp4
    (``mp4v``) at ``fps``."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    t, h, w = frames.shape[:3]
    is_color = frames.ndim == 4
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h), isColor=is_color)
    if not writer.isOpened():
        raise IOError(f"Cannot open video writer for {path}")
    for f in frames:
        writer.write(f if is_color else f.astype(np.uint8))
    writer.release()
    return path


def load_video_feats(
    path: Any,
    train: bool = False,
    image_crop_size: int = 88,
    image_mean: float = 0.421,
    image_std: float = 0.165,
    max_frames: Optional[int] = None,
) -> np.ndarray:
    """mp4 -> normalized [T, crop, crop, 1] float32 features."""
    import cv2

    frames = read_video_frames(path, grayscale=True, max_frames=max_frames)
    t, h, w = frames.shape
    if h < image_crop_size or w < image_crop_size:
        scale = image_crop_size / min(h, w)
        frames = np.stack(
            [cv2.resize(f, (int(round(w * scale)), int(round(h * scale)))) for f in frames]
        )
        t, h, w = frames.shape
    top = (h - image_crop_size) // 2
    left = (w - image_crop_size) // 2
    frames = frames[:, top : top + image_crop_size, left : left + image_crop_size]
    feats = frames.astype(np.float32) / 255.0
    feats = (feats - image_mean) / image_std
    return feats[..., None]


def trim_video_to_audio(video: np.ndarray, audio_samples: int,
                        sample_rate: int = 16000, fps: int = 25) -> np.ndarray:
    """Trim video frames to ``round(audio_samples / sample_rate * fps)``."""
    max_len = int(round(audio_samples / sample_rate * fps))
    return video[:max_len] if len(video) > max_len else video
