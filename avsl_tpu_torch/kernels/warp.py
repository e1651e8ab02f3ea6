"""Similarity-transform estimation and the batched bilinear lip-ROI warp.

Port of ``avsl_tpu/kernels/warp.py``. A similarity is carried as four
coefficient tensors ``(a, b, tx, ty)`` over any leading batch shape,
meaning ``dst = [[a, -b], [b, a]] @ src + (tx, ty)``, so the transform of
every frame of a clip (or of a batch of clips) is closed-form broadcast
arithmetic. Two warps cut a mouth-centred ``crop_size``² patch out of each
frame: :func:`warp_and_crop_clip` gathers its four bilinear taps (any
rotation), :func:`warp_and_crop_clip_separable` samples rotation-free
transforms as two matrix products a frame with banded interpolation
matrices (:func:`sample_separable`). Every function runs where its inputs
are and computes in float32; the products need TF32 off on the card
(``torch.backends.cuda.matmul.allow_tf32``, off by default), since TF32
would round the pixel values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
STABLE_IDX = (33, 36, 39, 42, 45)


def _seq_sum(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Sum over the last ``dims`` dims (a few landmarks) by sequential
    float32 additions in index order: the same bits on the CPU and on the
    card. The crop-window centre truncated to int32 below sits on a knife
    edge for synthesized landmarks (their warped mouth centre is the
    canonical one, 150.0 and 218.0, up to rounding), so its arithmetic must
    not depend on the device's reduction order."""
    x = x.reshape(*x.shape[: x.dim() - dims], -1)
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _seq_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over dim -2 of [..., N, 2] points by :func:`_seq_sum`, divided
    by a tensor: CUDA divides by a host scalar as a product with its
    rounded reciprocal, which rounds differently from the CPU's division."""
    total = _seq_sum(x.transpose(-1, -2))
    return total / torch.full_like(total, x.shape[-2])


def similarity_coeffs(src: torch.Tensor, dst: torch.Tensor) -> Coeffs:
    """Least-squares similarity transform src -> dst, batched.

    ``src``: [..., N, 2], ``dst``: [..., N, 2] or [N, 2] (broadcast).
    Returns ``(a, b, tx, ty)`` of the leading batch shape, from the closed
    form ``a = sum(s . d)/sum|s|^2``, ``b = sum(cross(s, d))/sum|s|^2`` over
    the centred points (reflections excluded), summed in a fixed order."""
    src = src.float()
    dst = dst.float()
    mu_s = _seq_mean(src)
    mu_d = _seq_mean(dst)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    num_a = _seq_sum(sc * dc, 2)
    num_b = _seq_sum(sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0])
    den = _seq_sum(sc * sc, 2).clamp_min(1e-8)
    a = num_a / den
    b = num_b / den
    tx = mu_d[..., 0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[..., 1] - (b * mu_s[..., 0] + a * mu_s[..., 1])
    return a, b, tx, ty


def inverse_coeffs(coeffs: Coeffs) -> Coeffs:
    """Invert batched similarity coefficients (same parameterisation)."""
    a, b, tx, ty = coeffs
    det = (a * a + b * b).clamp_min(1e-12)
    ia = a / det
    ib = -b / det
    itx = -(ia * tx - ib * ty)
    ity = -(ib * tx + ia * ty)
    return ia, ib, itx, ity


def apply_coeffs(points: torch.Tensor, coeffs: Coeffs) -> torch.Tensor:
    """Apply batched similarity coefficients to points [..., N, 2]."""
    a, b, tx, ty = coeffs
    x = points[..., 0]
    y = points[..., 1]
    return torch.stack(
        [
            a[..., None] * x - b[..., None] * y + tx[..., None],
            b[..., None] * x + a[..., None] * y + ty[..., None],
        ],
        dim=-1,
    )


def umeyama(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Similarity transform [N, 2] -> [N, 2] as a 2x3 matrix M with
    ``dst ~= src @ M[:, :2].T + M[:, 2]``."""
    a, b, tx, ty = similarity_coeffs(src, dst)
    return torch.stack([torch.stack([a, -b, tx]), torch.stack([b, a, ty])])


def invert_similarity(m: torch.Tensor) -> torch.Tensor:
    """Invert a 2x3 similarity matrix (closed form)."""
    ia, ib, itx, ity = inverse_coeffs((m[0, 0], m[1, 0], m[0, 2], m[1, 2]))
    return torch.stack([torch.stack([ia, -ib, itx]), torch.stack([ib, ia, ity])])


def _bilinear_sample(image: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` [..., H, W] at float coordinates xs/ys [..., h, w]
    (leading dims must match); each of the four taps counts only where it
    lies inside the frame, so the result is zero outside it."""
    h, w = image.shape[-2:]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = image.reshape(*image.shape[:-2], h * w)
    flat = flat.expand(*xs.shape[:-2], h * w)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, -1, idx.reshape(*idx.shape[:-2], -1)).reshape(idx.shape)
        return torch.where(valid, vals, 0.0)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def _grid(n_rows: int, n_cols: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row index, column index) float32 grids of shape [n_rows, n_cols]."""
    ys = torch.arange(n_rows, dtype=torch.float32, device=device)[:, None].expand(n_rows, n_cols)
    xs = torch.arange(n_cols, dtype=torch.float32, device=device)[None, :].expand(n_rows, n_cols)
    return ys, xs


def warp_frame(image: torch.Tensor, matrix: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Warp one frame [H, W] by a 2x3 forward matrix (src -> dst):
    ``output(y, x) = input(M^-1 @ (x, y))``."""
    inv = invert_similarity(matrix)
    ys, xs = _grid(out_h, out_w, image.device)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return _bilinear_sample(image.float(), sx, sy)


def transform_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply a 2x3 matrix to [N, 2] (x, y) points."""
    return points @ matrix[:, :2].T + matrix[:, 2]


def _crop_window_coeffs(
    landmarks: torch.Tensor,  # [..., 68, 2]
    mean_face: torch.Tensor,  # [68, 2]
    out_size: int,
    crop_size: int,
    stable_idx: Tuple[int, ...],
):
    """Batched transform and mouth-centred crop window for every frame:
    ``(inverse coeffs (dst -> src), cx, cy)``, the integer crop-window
    centres in warped space, of the landmarks' leading batch shape."""
    stable = list(stable_idx)
    half = crop_size // 2
    coeffs = similarity_coeffs(landmarks[..., stable, :], mean_face[stable])
    mouth = apply_coeffs(landmarks[..., 48:68, :], coeffs)
    center = _seq_mean(mouth)  # [..., 2] (x, y) in warped space
    cx = center[..., 0].clamp(half, out_size - half).to(torch.int32)
    cy = center[..., 1].clamp(half, out_size - half).to(torch.int32)
    return inverse_coeffs(coeffs), cx, cy


def warp_and_crop_clip(
    frames: torch.Tensor,  # [..., H, W] grayscale float/uint8
    landmarks: torch.Tensor,  # [..., 68, 2] (x, y)
    mean_face: torch.Tensor,  # [68, 2] canonical coords in out_size space
    out_size: int = 300,
    crop_size: int = 96,
    stable_idx: Tuple[int, ...] = STABLE_IDX,
) -> torch.Tensor:
    """Lip-ROI geometry for a clip (or a batch of clips).

    Per frame: the similarity from the stable landmarks to the mean face,
    the mouth landmarks (48..67) moved by it, and a ``crop_size``² patch
    around their mean sampled bilinearly from the source frame (the warp is
    evaluated on the crop grid only). Returns [..., crop_size, crop_size]
    float32."""
    half = crop_size // 2
    (ia, ib, itx, ity), cx, cy = _crop_window_coeffs(
        landmarks, mean_face, out_size, crop_size, stable_idx
    )
    grid_y, grid_x = _grid(crop_size, crop_size, frames.device)
    ys = grid_y + (cy - half).float()[..., None, None]
    xs = grid_x + (cx - half).float()[..., None, None]
    e = (...,) + (None, None)
    sx = ia[e] * xs - ib[e] * ys + itx[e]
    sy = ib[e] * xs + ia[e] * ys + ity[e]
    return _bilinear_sample(frames.float(), sx, sy)


def separable_crop_coords(
    landmarks: torch.Tensor,  # [..., 68, 2] (x, y)
    mean_face: torch.Tensor,  # [68, 2]
    out_size: int = 300,
    crop_size: int = 96,
    stable_idx: Tuple[int, ...] = STABLE_IDX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame separable source coordinates (ys, xs), each [...,
    crop_size]: ``crops[..., i, j] = frame[ys[..., i], xs[..., j]]``
    (bilinear), for transforms without rotation (``ib ~= 0``)."""
    half = crop_size // 2
    (ia, _ib, itx, ity), cx, cy = _crop_window_coeffs(
        landmarks, mean_face, out_size, crop_size, stable_idx
    )
    grid = torch.arange(crop_size, dtype=torch.float32, device=landmarks.device)
    xs = (grid + (cx - half).float()[..., None]) * ia[..., None] + itx[..., None]
    ys = (grid + (cy - half).float()[..., None]) * ia[..., None] + ity[..., None]
    return ys, xs


def separable_crop_coords_np(
    landmarks: np.ndarray,  # [..., 68, 2]
    mean_face: np.ndarray,  # [68, 2]
    out_size: int = 300,
    crop_size: int = 96,
    stable_idx: Tuple[int, ...] = STABLE_IDX,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy) twin of :func:`separable_crop_coords`, equal up to
    float summation order: the coefficient arithmetic is a few kFLOP a
    frame, so host pipelines compute it next to their landmarks."""
    lm = np.asarray(landmarks, np.float32)
    mf = np.asarray(mean_face, np.float32)
    stable = np.asarray(stable_idx)
    half = crop_size // 2

    sel = lm[..., stable, :]
    dst = mf[stable]
    mu_s = sel.mean(axis=-2)
    mu_d = dst.mean(axis=0)
    sc = sel - mu_s[..., None, :]
    dc = dst - mu_d
    num_a = (sc * dc).sum(axis=(-2, -1))
    num_b = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(axis=-1)
    den = np.maximum((sc * sc).sum(axis=(-2, -1)), 1e-8)
    a = num_a / den
    b = num_b / den
    tx = mu_d[0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[1] - (b * mu_s[..., 0] + a * mu_s[..., 1])

    mouth = lm[..., 48:68, :]
    mx = a[..., None] * mouth[..., 0] - b[..., None] * mouth[..., 1] + tx[..., None]
    my = b[..., None] * mouth[..., 0] + a[..., None] * mouth[..., 1] + ty[..., None]
    cx = np.clip(mx.mean(axis=-1), half, out_size - half).astype(np.int32)
    cy = np.clip(my.mean(axis=-1), half, out_size - half).astype(np.int32)

    det = np.maximum(a * a + b * b, 1e-12)
    ia = a / det
    ib = -b / det
    itx = -(ia * tx - ib * ty)
    ity = -(ib * tx + ia * ty)

    grid = np.arange(crop_size, dtype=np.float32)
    xs = (grid + (cx - half).astype(np.float32)[..., None]) * ia[..., None] + itx[..., None]
    ys = (grid + (cy - half).astype(np.float32)[..., None]) * ia[..., None] + ity[..., None]
    return ys, xs


def _interp_matrix(coords: torch.Tensor, n: int) -> torch.Tensor:
    """[..., crop, n] banded bilinear weights ``max(0, 1 - |c - k|)``. A
    tap exists only for k in [0, n), so coordinates in (-1, 0) and
    (n-1, n) keep their one in-frame partial weight (the gather warp's
    per-tap masking) and coordinates beyond that weigh nothing."""
    k = torch.arange(n, dtype=torch.float32, device=coords.device)
    return (1.0 - (coords[..., None] - k).abs()).clamp_min(0.0)


def sample_separable(
    frames: torch.Tensor,  # [..., H, W] grayscale float/uint8
    ys: torch.Tensor,  # [..., crop] per-frame source row coords
    xs: torch.Tensor,  # [..., crop] per-frame source col coords
    chunk: int = 32,
) -> torch.Tensor:
    """Separable bilinear resampling as two fp32 matrix products a frame,
    ``out = Wy @ frame @ Wx^T``, with the banded interpolation matrices
    built on the fly.

    Frames go in groups of ``chunk`` (the last group padded with zero
    frames at coordinate -1, which weigh nothing), each converted to float
    in its turn, so the [chunk, crop, H] matrices and the float frames
    never exist for the whole batch at once. Returns [..., crop, crop]
    float32."""
    batch_shape = frames.shape[:-2]
    h, w = frames.shape[-2:]
    c = ys.shape[-1]
    n = int(np.prod(batch_shape)) if batch_shape else 1
    f = frames.reshape(n, h, w)
    ysf = ys.reshape(n, c).float()
    xsf = xs.reshape(n, c).float()

    def sample_group(fb, yb, xb):
        wy = _interp_matrix(yb, h)  # [m, crop, H]
        wx = _interp_matrix(xb, w)  # [m, crop, W]
        tmp = torch.bmm(wy, fb.float())
        return torch.bmm(tmp, wx.transpose(1, 2))

    if n <= chunk:
        out = sample_group(f, ysf, xsf)
    else:
        pad = (-n) % chunk
        if pad:
            f = torch.cat([f, f.new_zeros((pad, h, w))])
            ysf = torch.cat([ysf, ysf.new_full((pad, c), -1.0)])
            xsf = torch.cat([xsf, xsf.new_full((pad, c), -1.0)])
        out = torch.cat([
            sample_group(f[s:s + chunk], ysf[s:s + chunk], xsf[s:s + chunk])
            for s in range(0, n + pad, chunk)
        ])[:n]
    return out.reshape(*batch_shape, c, c)


def warp_and_crop_clip_separable(
    frames: torch.Tensor,  # [..., H, W] grayscale float/uint8
    landmarks: torch.Tensor,  # [..., 68, 2] (x, y)
    mean_face: torch.Tensor,  # [68, 2]
    out_size: int = 300,
    crop_size: int = 96,
    stable_idx: Tuple[int, ...] = STABLE_IDX,
) -> torch.Tensor:
    """Rotation-free lip-ROI warp: :func:`separable_crop_coords` then
    :func:`sample_separable`. Equals :func:`warp_and_crop_clip` for
    transforms without rotation; batched over any leading dims."""
    ys, xs = separable_crop_coords(landmarks, mean_face, out_size, crop_size, stable_idx)
    return sample_separable(frames, ys, xs)


def rgb_to_grayscale(frames: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma: [..., H, W, 3] uint8/float -> [..., H, W] float32."""
    frames = frames.float()
    return 0.299 * frames[..., 0] + 0.587 * frames[..., 1] + 0.114 * frames[..., 2]


def center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Centre-crop [..., H, W] to [..., size, size]."""
    h, w = frames.shape[-2], frames.shape[-1]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return frames[..., top: top + size, left: left + size]


def normalize_frames(frames: torch.Tensor, mean: float = 0.421, std: float = 0.165) -> torch.Tensor:
    """[0, 255] -> [0, 1] (when the clip's maximum is above 1.5), then
    ``(x - mean) / std``, the AV-HuBERT convention."""
    x = frames.float()
    x = torch.where(x.max() > 1.5, x / 255.0, x)
    return (x - mean) / std
