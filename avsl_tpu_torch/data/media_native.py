"""ctypes binding for the native media runtime (cpp/avsl_media).

Port of ``avsl_tpu/data/media_native.py``: the same shared library, built
at first use by ``avsl_tpu_torch.utils.native_build.ensure_built``. Its
cv2 path is host decode when the library is absent (no libav headers) or
cannot load (libav's shared libraries missing), not a fallback from a
device or a kernel.

Provides threaded batch decode of video (grayscale uint8 into one staging
arena) and audio (mono float32 at a target rate) via libav — the
framework's replacement for the reference's ffmpeg-subprocess / decord /
OpenCV decode paths. Falls back to the cv2-based implementations in
avsl_tpu_torch.data.video_io when the shared library has not been built
(``make -C cpp/avsl_media`` into ``build/avsl_tpu_torch/native/``).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "cpp", "avsl_media")
_LIB_NAME = "libavsl_media.so"


@functools.lru_cache(maxsize=1)
def _load_lib() -> Optional[ctypes.CDLL]:
    from avsl_tpu_torch.utils.native_build import ensure_built

    built = ensure_built(_LIB_DIR, _LIB_NAME)
    for path in (built, os.path.join(os.path.dirname(os.path.abspath(__file__)), _LIB_NAME)):
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:  # built elsewhere: libav's shared libraries are not here
                continue
            lib.avsl_decode_video_gray.restype = ctypes.c_int
            lib.avsl_decode_video_gray.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ]
            lib.avsl_decode_audio_f32.restype = ctypes.c_int64
            lib.avsl_decode_audio_f32.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            lib.avsl_decode_video_batch.restype = None
            lib.avsl_decode_video_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
            lib.avsl_decode_audio_batch.restype = None
            lib.avsl_decode_audio_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
            return lib
    return None


def native_available() -> bool:
    return _load_lib() is not None


def decode_video_gray(
    path: str,
    max_frames: int = 30000,
    out_size: Optional[Tuple[int, int]] = None,
    start_sec: float = 0.0,
    end_sec: float = 0.0,
) -> np.ndarray:
    """Decode to [T, H, W] uint8 grayscale via the native module (or cv2).

    Default ``max_frames`` bounds the output buffer (~3 GB virtual at
    288x352; 20 min @ 25 fps) — pass an explicit cap for longer media.
    The cv2 fallback honors ``start_sec``/``end_sec`` by frame-index
    slicing at the container fps (cv2 has no reliable seek)."""
    lib = _load_lib()
    if lib is None:
        import cv2

        from avsl_tpu_torch.data.video_io import read_video_frames

        if start_sec > 0.0 or end_sec > 0.0:
            cap = cv2.VideoCapture(path)
            fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
            cap.release()
            first = int(round(start_sec * fps))
            last = int(round(end_sec * fps)) if end_sec > 0.0 else None
            need = (last if last is not None else first + max_frames)
            frames = read_video_frames(path, grayscale=True, max_frames=need)
            frames = frames[first:last][:max_frames]
            if len(frames) == 0:
                raise IOError(
                    f"no frames in [{start_sec}, {end_sec}]s of {path}"
                )
        else:
            frames = read_video_frames(
                path, grayscale=True, max_frames=max_frames
            )
        if out_size is not None:
            w, h = out_size
            frames = np.stack([cv2.resize(f, (w, h)) for f in frames])
        return frames

    ow, oh = out_size if out_size is not None else (0, 0)
    if out_size is None:
        # probe with a 1-frame decode at native size to get dims
        probe = np.zeros(32_000_000, np.uint8)
        w = ctypes.c_int(); h = ctypes.c_int(); fps = ctypes.c_double()
        n = lib.avsl_decode_video_gray(
            path.encode(), probe.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            probe.nbytes, 1, 0, 0, 0.0, 0.0,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
        )
        if n <= 0:
            raise IOError(f"native decode failed ({n}) for {path}")
        ow, oh = w.value, h.value
    buf = np.empty(max_frames * ow * oh, np.uint8)
    w = ctypes.c_int(); h = ctypes.c_int(); fps = ctypes.c_double()
    n = lib.avsl_decode_video_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.nbytes, max_frames, ow, oh, start_sec, end_sec,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
    )
    if n < 0:
        raise IOError(f"native decode failed (err {-n}) for {path}")
    return buf[: n * ow * oh].reshape(n, oh, ow).copy()


def decode_audio(
    path: str, target_sr: int = 16000, max_seconds: float = 120.0
) -> Tuple[np.ndarray, int]:
    """Decode mono float32 audio; returns (samples, sample_rate)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(
            "native media module not built (make -C cpp/avsl_media) and no "
            "python fallback exists for compressed audio"
        )
    max_samples = int(max_seconds * target_sr)
    buf = np.empty(max_samples, np.float32)
    sr = ctypes.c_int()
    n = lib.avsl_decode_audio_f32(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, target_sr, ctypes.byref(sr),
    )
    if n < 0:
        raise IOError(f"native audio decode failed (err {-n}) for {path}")
    return buf[:n].copy(), sr.value


def decode_video_batch(
    paths: Sequence[str],
    out_size: Tuple[int, int],
    max_frames: int,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode many clips concurrently into one staging arena.

    Returns (arena [N, max_frames, H, W] uint8, frame_counts [N] int32);
    failed clips have count <= 0.
    """
    lib = _load_lib()
    w, h = out_size
    n = len(paths)
    arena = np.zeros((n, max_frames, h, w), np.uint8)
    counts = np.zeros(n, np.int32)
    if lib is None:
        for i, p in enumerate(paths):
            try:
                f = decode_video_gray(p, max_frames, out_size)
                arena[i, : len(f)] = f
                counts[i] = len(f)
            except Exception:
                counts[i] = -1
        return arena, counts

    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_counts = (ctypes.c_int * n)()
    lib.avsl_decode_video_batch(
        c_paths, n, arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arena.strides[0], max_frames, w, h, c_counts, num_threads,
    )
    counts[:] = np.frombuffer(c_counts, np.int32, n)
    return arena, counts


def decode_audio_batch(
    paths: Sequence[str],
    target_sr: int = 16000,
    max_samples: int = 160000,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode many audio files concurrently; returns (arena [N, max_samples]
    float32, sample_counts [N] int64)."""
    lib = _load_lib()
    n = len(paths)
    arena = np.zeros((n, max_samples), np.float32)
    counts = np.zeros(n, np.int64)
    if lib is None:
        raise RuntimeError("native media module not built")
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_counts = (ctypes.c_int64 * n)()
    lib.avsl_decode_audio_batch(
        c_paths, n, arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, target_sr, c_counts, num_threads,
    )
    counts[:] = np.frombuffer(c_counts, np.int64, n)
    return arena, counts
