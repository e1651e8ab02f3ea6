"""ctypes binding for the shared host lip-crop sampler (``cpp/avsl_warp``).

Port of ``avsl_tpu/kernels/warp_native.py``. A threaded C++ separable
bilinear sampler for uint8 frames, the host twin of
:func:`avsl_tpu_torch.kernels.warp.sample_separable` (per-tap masking,
float32 accumulation); :func:`sample_separable_np` computes the same in
numpy when the library is not built (``make -C cpp/avsl_warp`` into
``build/avsl_tpu_torch/native/``, which
:func:`avsl_tpu_torch.utils.native_build.ensure_built` tries once).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "cpp", "avsl_warp")
_LIB_NAME = "libavsl_warp.so"


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
    common = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.avsl_sample_separable_f32.restype = None
    lib.avsl_sample_separable_f32.argtypes = common + [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.avsl_sample_separable_u8.restype = None
    lib.avsl_sample_separable_u8.argtypes = common + [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def sample_separable_np(
    frames: np.ndarray,  # [..., H, W] uint8 (or float castable)
    ys: np.ndarray,  # [..., crop] per-frame source row coords
    xs: np.ndarray,  # [..., crop] per-frame source col coords
    chunk: int = 64,
) -> np.ndarray:
    """Numpy twin of ``kernels.warp.sample_separable``: a bilinear tap
    counts iff its integer index lies in [0, n). ``chunk`` frames at a time.
    Returns float32 [..., crop, crop]."""
    batch_shape = frames.shape[:-2]
    h, w = frames.shape[-2:]
    c = ys.shape[-1]
    f = frames.reshape(-1, h, w)
    ysf = np.asarray(ys, np.float32).reshape(-1, c)
    xsf = np.asarray(xs, np.float32).reshape(-1, c)
    n = f.shape[0]
    out = np.empty((n, c, c), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        fb = f[s:e].astype(np.float32)
        xb, yb = xsf[s:e], ysf[s:e]
        x0 = np.floor(xb).astype(np.int64)
        fx = xb - x0
        v0 = (x0 >= 0) & (x0 < w)
        v1 = (x0 + 1 >= 0) & (x0 + 1 < w)
        x0c = np.clip(x0, 0, w - 1)
        x1c = np.clip(x0 + 1, 0, w - 1)
        g0 = np.take_along_axis(fb, x0c[:, None, :], axis=2)
        g1 = np.take_along_axis(fb, x1c[:, None, :], axis=2)
        tmp = g0 * (v0 * (1.0 - fx))[:, None, :] + g1 * (v1 * fx)[:, None, :]
        y0 = np.floor(yb).astype(np.int64)
        fy = yb - y0
        u0 = (y0 >= 0) & (y0 < h)
        u1 = (y0 + 1 >= 0) & (y0 + 1 < h)
        y0c = np.clip(y0, 0, h - 1)
        y1c = np.clip(y0 + 1, 0, h - 1)
        r0 = np.take_along_axis(tmp, y0c[:, :, None], axis=1)
        r1 = np.take_along_axis(tmp, y1c[:, :, None], axis=1)
        out[s:e] = r0 * (u0 * (1.0 - fy))[:, :, None] + r1 * (u1 * fy)[:, :, None]
    return out.reshape(*batch_shape, c, c)


def sample_separable_host(
    frames: np.ndarray,  # [..., H, W] uint8
    ys: np.ndarray,  # [..., crop]
    xs: np.ndarray,  # [..., crop]
    out_dtype=np.uint8,
    n_threads: Optional[int] = None,
) -> np.ndarray:
    """The threaded library, or the numpy twin when it is absent or the
    frames are not uint8 (so the result never depends on the build).
    ``out_dtype=np.uint8`` clips to [0, 255] and truncates, as
    ``lip_roi.extract_lip_clip`` stores crops; ``np.float32`` returns the
    raw values."""
    n = int(np.prod(np.shape(frames)[:-2]))
    if int(np.prod(np.shape(ys)[:-1])) != n or int(np.prod(np.shape(xs)[:-1])) != n:
        raise ValueError(
            f"coords batch {np.shape(ys)[:-1]}/{np.shape(xs)[:-1]} does not "
            f"match frames batch {np.shape(frames)[:-2]}"
        )
    lib = _load_lib()
    if lib is None or np.asarray(frames).dtype != np.uint8:
        outf = sample_separable_np(frames, ys, xs)
        if out_dtype == np.uint8:
            return np.clip(outf, 0, 255).astype(np.uint8)
        return outf.astype(out_dtype)
    f = np.ascontiguousarray(frames, np.uint8)
    batch_shape = f.shape[:-2]
    h, w = f.shape[-2:]
    c = ys.shape[-1]
    ysf = np.ascontiguousarray(ys, np.float32).reshape(-1, c)
    xsf = np.ascontiguousarray(xs, np.float32).reshape(-1, c)
    f = f.reshape(n, h, w)
    threads = n_threads or min(os.cpu_count() or 1, 8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    if out_dtype == np.uint8:
        out = np.empty((n, c, c), np.uint8)
        lib.avsl_sample_separable_u8(f.ctypes.data_as(u8p), n, h, w, ysf.ctypes.data_as(f32p),
                                     xsf.ctypes.data_as(f32p), c, out.ctypes.data_as(u8p), threads)
    elif out_dtype == np.float32:
        out = np.empty((n, c, c), np.float32)
        lib.avsl_sample_separable_f32(f.ctypes.data_as(u8p), n, h, w, ysf.ctypes.data_as(f32p),
                                      xsf.ctypes.data_as(f32p), c, out.ctypes.data_as(f32p), threads)
    else:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    return out.reshape(*batch_shape, c, c)
