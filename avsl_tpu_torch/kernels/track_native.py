"""ctypes binding for the shared host NCC mouth tracker (``cpp/avsl_track``).

Port of ``avsl_tpu/kernels/track_native.py``. One batched call with the
GIL released runs the per-clip tracking (``::ds`` downsample, zero-mean
NCC score maps through OpenCV's ``matchTemplate``, square-NMS top-k peaks,
Viterbi peak selection, strided-frame interpolation): the native twin of
:func:`avsl_tpu_torch.data.track_host.ncc_track_clip_parallel_np`.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "cpp", "avsl_track")
_LIB_NAME = "libavsl_track.so"


@functools.lru_cache(maxsize=1)
def _load_lib() -> Optional[ctypes.CDLL]:
    from avsl_tpu_torch.utils.native_build import ensure_built

    path = ensure_built(_LIB_DIR, _LIB_NAME)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.avsl_track_ncc_batch.restype = None
    lib.avsl_track_ncc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # clips
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B T H W
        ctypes.c_int,  # ds
        ctypes.POINTER(ctypes.c_float),  # anchor_pos [B, 2]
        ctypes.c_int,  # anchor
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ts/search/stride/k
        ctypes.c_float,  # motion_lambda
        ctypes.c_int,  # n_threads
        ctypes.POINTER(ctypes.c_float),  # out_traj [B, T, 2]
        ctypes.POINTER(ctypes.c_uint8),  # ok [B]
    ]
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _cv2_wheel_available() -> bool:
    from avsl_tpu_torch.data import track_host

    return bool(track_host._HAS_CV2)


def ncc_track_batch_host(
    clips: np.ndarray,  # [B, T, H, W] uint8, full resolution
    anchor_pos: np.ndarray,  # [B, 2] (x, y) at the ::ds-downsampled scale
    anchor: int,
    ds: int = 1,
    template_size: int = 48,
    search: int = 80,
    stride: int = 1,
    top_k: int = 1,
    motion_lambda: float = 0.02,
    n_threads: Optional[int] = None,
    prefer: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """[B, T, 2] (x, y) trajectories at the downsampled scale and ok [B].

    ``prefer="auto"`` takes the Python OpenCV's ``matchTemplate`` when it
    imports, else the library, else the numpy FFT twin; ``"native"`` takes
    the library when it is built. Every backend computes the same
    statistic (near-tie peaks can differ between OpenCV builds by an ulp).
    ``ok[b]`` is False where the downsampled frame leaves no search window;
    that row holds the anchor position."""
    clips = np.ascontiguousarray(clips)
    if clips.ndim != 4:
        raise ValueError(f"expected [B, T, H, W], got {clips.shape}")
    b, t, h, w = clips.shape
    ap = np.ascontiguousarray(anchor_pos, np.float32).reshape(b, 2)
    lib = _load_lib()
    use_native = (
        lib is not None
        and clips.dtype == np.uint8
        and (prefer == "native" or (prefer == "auto" and not _cv2_wheel_available()))
    )
    if use_native:
        out = np.empty((b, t, 2), np.float32)
        ok = np.empty((b,), np.uint8)
        threads = n_threads or min(os.cpu_count() or 1, 8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.avsl_track_ncc_batch(
            clips.ctypes.data_as(u8p), b, t, h, w, int(ds), ap.ctypes.data_as(f32p), int(anchor),
            int(template_size), int(search), int(stride), int(top_k), float(motion_lambda),
            int(threads), out.ctypes.data_as(f32p), ok.ctypes.data_as(u8p),
        )
        okb = ok.astype(bool)
        for i in np.nonzero(~okb)[0]:
            out[i] = ap[i][None]
        return out, okb

    from avsl_tpu_torch.data.track_host import ncc_track_clip_parallel_np

    out = np.empty((b, t, 2), np.float32)
    ok = np.ones((b,), bool)
    for i in range(b):
        small = clips[i, :, ::ds, ::ds] if ds > 1 else clips[i]
        hh, ww = small.shape[-2:]
        eff_search = min(search, (min(hh, ww) - template_size - 2) // 2)
        if eff_search < 1 or min(hh, ww) < template_size:
            out[i] = ap[i][None]
            ok[i] = False
            continue
        out[i] = ncc_track_clip_parallel_np(
            small, ap[i], anchor, template_size=template_size, search=search, stride=stride,
            top_k=top_k, motion_lambda=motion_lambda,
        )
    return out, ok
