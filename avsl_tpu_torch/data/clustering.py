"""k-means cluster targets for AV-HuBERT pretraining.

Port of ``avsl_tpu/data/clustering.py`` (the role of fairseq's
``learn_kmeans.py`` and ``dump_km_label.py``): k-means++ seeding on a host
subsample with numpy, the same ``np.random.default_rng(seed)`` calls in the
same order as JAX; then Lloyd iterations as torch ops on the device, over
static chunks of the points: the E-step's distances as one ``[B, D] x
[D, K]`` product (``argmin |c|^2 - 2 x.c``; ``|x|^2`` only for the
inertia), the M-step as a weighted one-hot product, padded points
weighing 0, and an empty cluster keeping its previous centroid.

:class:`KMeansQuantizer` wraps fit and assign and reads and writes the
JAX package's npz (key ``centroids``), so a codebook written by either
package loads in the other. Runs on ``cuda`` unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from avsl_tpu_torch.core.device import resolve_device

__all__ = ["KMeansQuantizer", "kmeans_assign", "kmeans_fit"]

Features = Union[np.ndarray, torch.Tensor]


def _pp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding on the host (``clustering.py:36-47``)."""
    n = x.shape[0]
    centroids = np.empty((k, x.shape[1]), x.dtype)
    centroids[0] = x[rng.integers(n)]
    d2 = np.sum((x - centroids[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centroids[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((x - centroids[i]) ** 2, axis=1))
    return centroids


def _lloyd(x: torch.Tensor, w: torch.Tensor, centroids: torch.Tensor, n_iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` Lloyd iterations over chunked points ``x`` [C, B, D] with
    weights ``w`` [C, B] (0 = padding): (centroids, the last iteration's
    inertia), fp32 on ``x``'s device, with no host sync."""
    k = centroids.shape[0]
    inertia = torch.zeros((), device=x.device)
    for _ in range(n_iters):
        sums = torch.zeros_like(centroids)
        counts = torch.zeros(k, device=x.device)
        inertia = torch.zeros((), device=x.device)
        c_sq = (centroids * centroids).sum(dim=1)[None, :]
        for xc, wc in zip(x, w):
            d2 = c_sq - 2.0 * (xc @ centroids.T)  # [B, K]
            labels = d2.argmin(dim=1)  # ties go to the first centroid
            best = d2.gather(1, labels[:, None])[:, 0]
            one_hot = F.one_hot(labels, k).float() * wc[:, None]
            sums = sums + one_hot.T @ xc
            counts = counts + one_hot.sum(dim=0)
            inertia = inertia + ((best + (xc * xc).sum(dim=1)) * wc).sum()
        centroids = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None],
                                centroids)
    return centroids, inertia


def _chunked(feats: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = feats.shape
    pad = (-n) % chunk
    w = torch.ones(n, device=feats.device)
    if pad:
        feats = torch.cat([feats, feats.new_zeros((pad, d))])
        w = torch.cat([w, w.new_zeros(pad)])
    return feats.reshape(-1, chunk, d), w.reshape(-1, chunk)


def _as_tensor(features: Features, device: torch.device) -> torch.Tensor:
    if isinstance(features, torch.Tensor):
        return features.to(device, torch.float32)
    return torch.as_tensor(np.asarray(features, np.float32), device=device)


def kmeans_fit(
    features: Features,
    k: int,
    n_iters: int = 25,
    seed: int = 0,
    init: str = "kmeans++",
    chunk: int = 65536,
    init_subsample: int = 100_000,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, float]:
    """Fit ``k`` centroids on ``[N, D]`` features (a numpy array, or a
    tensor, which stays on its device for the Lloyd iterations); returns
    ``(centroids [k, D], inertia)`` as JAX's ``kmeans_fit`` does. The seeding
    reads the points on the host."""
    dev = resolve_device(device)
    x = _as_tensor(features, dev)
    if x.ndim != 2:
        raise ValueError(f"features must be [N, D], got {tuple(x.shape)}")
    n = x.shape[0]
    if n < k:
        raise ValueError(f"need at least k={k} points, got {n}")
    host = x.cpu().numpy()
    rng = np.random.default_rng(seed)
    sub = host
    if n > init_subsample:
        sub = host[rng.choice(n, init_subsample, replace=False)]
    if init == "kmeans++":
        init_c = _pp_init(sub, k, rng)
    elif init == "random":
        init_c = sub[rng.choice(len(sub), k, replace=False)]
    else:
        raise ValueError(f"unknown init {init!r}")
    xc, w = _chunked(x, min(chunk, max(256, n)))
    centroids, inertia = _lloyd(xc, w, torch.as_tensor(init_c, device=dev), n_iters)
    return centroids.cpu().numpy(), float(inertia)


def kmeans_assign(features: Features, centroids: Features,
                  device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Nearest-centroid int32 labels for ``[..., D]`` features."""
    dev = resolve_device(device)
    feats, c = _as_tensor(features, dev), _as_tensor(centroids, dev)
    flat = feats.reshape(-1, feats.shape[-1])
    labels = ((c * c).sum(dim=1)[None, :] - 2.0 * (flat @ c.T)).argmin(dim=1)
    return labels.to(torch.int32).cpu().numpy().reshape(tuple(feats.shape[:-1]))


class KMeansQuantizer:
    """Codebook wrapper: ``fit`` / ``__call__`` / ``save`` / ``load`` (npz,
    key ``centroids``; fairseq's ``.km`` files' role). ``device`` is where
    fitting and assignment run."""

    def __init__(self, centroids: Optional[np.ndarray] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.centroids = centroids
        self.device = device

    @property
    def n_clusters(self) -> int:
        return 0 if self.centroids is None else len(self.centroids)

    def fit(self, features: Features, k: int, **kw) -> "KMeansQuantizer":
        self.centroids, self.inertia = kmeans_fit(features, k, device=self.device, **kw)
        return self

    def __call__(self, features: Features) -> np.ndarray:
        if self.centroids is None:
            raise ValueError("quantizer not fitted")
        return kmeans_assign(features, self.centroids, device=self.device)

    def save(self, path: str) -> None:
        np.savez(path, centroids=self.centroids)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda") -> "KMeansQuantizer":
        with np.load(path) as z:
            return cls(z["centroids"], device=device)
