"""The one generator of inputs: every traffic mix is a set of parameters
for it (``traffic/<name>.json``), and every draw comes from the run's
seed.

Sizes do not depend on the seed: the pool of items has a fixed size, the
transcript lengths are fixed quantiles of their heavy-tailed law, and the
seed picks the values and the order. Large arrays (PCM and lip frames)
are drawn on the device from a ``torch.Generator`` in one call each and
brought to the host once.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

SAMPLE_RATE = 16000
# meeting words whose text normalisation is the identity
WORDS = ("yeah so the um we think that design remote control button meeting project "
         "market price cost user interface battery case colour shape idea good right "
         "okay well maybe next point agree kind speech voice screen menu channel volume "
         "power simple function people young fancy trend fruit rubber plastic spongy "
         "kinetic chip scroll wheel solar cell logo company budget euro twelve fifty "
         "production evaluation criteria minutes report").split()


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 1000003 + stream) & ((1 << 63) - 1))
    return g


def audio(n: int, seconds: float, seed: int, device) -> np.ndarray:
    """[n, samples] float32 noise with a slow seeded envelope (silences and
    louder stretches), peak under 1."""
    g = torch_gen(seed, 1, device)
    samples = int(seconds * SAMPLE_RATE)
    x = torch.randn((n, samples), generator=g, device=device)
    env = torch.rand((n, samples // 1600 + 1), generator=g, device=device)
    env = torch.repeat_interleave(env, 1600, dim=1)[:, :samples]
    return (0.08 * x * env).clamp(-1.0, 1.0).cpu().numpy()


def lip_frames(n: int, frames: int, crop: int, seed: int, device) -> np.ndarray:
    """[n, frames, crop, crop] uint8 grey lip crops: a seeded still per
    clip with seeded noise per frame."""
    g = torch_gen(seed, 2, device)
    base = torch.randint(40, 216, (n, 1, crop, crop), generator=g, device=device,
                         dtype=torch.int16)
    noise = torch.randint(-24, 25, (n, frames, crop, crop), generator=g, device=device,
                          dtype=torch.int16)
    return (base + noise).clamp(0, 255).to(torch.uint8).cpu().numpy()


def normalise(frames_u8, mean: float = 0.421, std: float = 0.165):
    """uint8 frames -> ``(x / 255 - mean) / std`` float32, the lip-clip
    loader's normalisation."""
    return (np.asarray(frames_u8, np.float32) / 255.0 - mean) / std


def transcripts(n: int, spec: Dict[str, Any], seed: int) -> List[str]:
    """``n`` transcripts whose word counts are the quantiles (i + 0.5) / n
    of a Pareto law (``pareto_alpha``) from ``min_words``, capped at
    ``max_words``, in a seeded order, of seeded words."""
    r = rng(seed, 3)
    q = (np.arange(n) + 0.5) / n
    counts = np.minimum(spec["min_words"] * (1.0 - q) ** (-1.0 / spec["pareto_alpha"]),
                        spec["max_words"]).astype(int)
    counts = r.permutation(counts)
    return [" ".join(r.choice(WORDS, size=int(c))) for c in counts]


def order(n_pool: int, count: int, seed: int, stream: int = 4) -> np.ndarray:
    """``count`` pool indices: seeded permutations of the pool, one after
    another."""
    r = rng(seed, stream)
    reps = -(-count // n_pool)
    return np.concatenate([r.permutation(n_pool) for _ in range(reps)])[:count]


def label_ids(n: int, spec: Dict[str, Any], vocab: int, seed: int) -> List[List[int]]:
    """``n`` label sequences whose lengths are spread evenly over
    [``min``, ``max``] in a seeded order, of seeded ids in [4, vocab - 1)."""
    r = rng(seed, 9)
    lengths = r.permutation(np.round(np.linspace(spec["min"], spec["max"], n)).astype(int))
    return [r.integers(4, vocab - 1, int(k)).tolist() for k in lengths]


def features(n: int, frames: int, dim: int, seed: int, device) -> np.ndarray:
    """[n, frames, dim] float32 N(0, 1): normalised audio features."""
    g = torch_gen(seed, 10, device)
    return torch.randn((n, frames, dim), generator=g, device=device).cpu().numpy()
