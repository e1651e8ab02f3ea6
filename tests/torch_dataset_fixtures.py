"""Dataset trees on disk for the port's dataset tests, written by the
port's own writer (``avsl_tpu_torch.data.hf_dataset.av_to_hf_dataset``;
``tests/test_torch_data_l3.py`` holds it to the JAX package's on the same
records): one ``save_to_disk`` directory per split, rows of ``id``,
``transcript``, ``duration`` and ``audio`` (a wav path cast to an
undecoded ``datasets.Audio``, its bytes embedded on save). Also a pool
worker for the chunked-processing tests, at module level so that a
spawned worker can import it."""

import os

import numpy as np
import scipy.io.wavfile as wavfile

from avsl_tpu_torch.data.hf_dataset import av_to_hf_dataset

WORDS = ("meeting", "the", "remote", "control", "design", "button", "we", "should", "think",
         "about", "battery", "price", "user", "interface", "yeah", "okay")


def records(directory, n, seed, durations, rates=None, prefix="u"):
    """``n`` rows of seeded noise wavs (int16) of ``durations[i]`` seconds
    at ``rates[i]`` Hz (16 kHz by default) with short word transcripts."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    out = []
    for i in range(n):
        sr = 16000 if rates is None else int(rates[i])
        dur = float(durations[i])
        pcm = (0.2 * rng.standard_normal(int(sr * dur)) * 32767).astype(np.int16)
        path = os.path.join(directory, f"{prefix}{i}.wav")
        wavfile.write(path, sr, pcm)
        words = [WORDS[int(j)] for j in rng.integers(len(WORDS), size=int(rng.integers(1, 6)))]
        out.append({"id": f"{prefix}{i}", "transcript": " ".join(words), "duration": dur,
                    "audio": path})
    return out


def write_tree(root, sizes, seed=0, durations=None, rates=None):
    """One split directory under ``root`` per entry of ``sizes`` (name ->
    rows); ``durations`` / ``rates`` map a split to its per-row values
    (default: 0.3-0.95 s at 16 kHz). Returns the records by split."""
    out = {}
    for k, (name, n) in enumerate(sizes.items()):
        durs = (durations or {}).get(name, 0.3 + 0.05 * (np.arange(n) % 14))
        recs = records(os.path.join(str(root), "wavs", name), n, seed + k, durs,
                       (rates or {}).get(name), prefix=name)
        av_to_hf_dataset(recs, os.path.join(str(root), name), check_videos=False)
        out[name] = recs
    return out


def boom_on_three(x):
    """A pool item that raises on 3 and doubles anything else."""
    if x == 3:
        raise ValueError("corrupt item")
    return True, x * 2
