"""HuggingFace dataset packaging (L3).

Port of ``avsl_tpu/data/hf_dataset.py`` (``datasets`` is imported only
where a ``datasets.Dataset`` is built). Parity with the reference's
utils/huggingface_utils.py:

* ``av_to_hf_dataset`` (:28-107): records -> ``datasets.Dataset`` with
  ``Audio(16000)`` / ``Video()`` feature casts and corruption filtering
  before save;
* ``av_to_hf_dataset_with_shards`` (:109-283): sharded on-disk layout
  ``data/shard_NNNN/`` with records assigned round-robin, per-shard
  ``metadata.jsonl`` plus a global CSV index;
* ``push_dataset_to_hub`` (:287-431): Hub upload with exponential backoff
  on HTTP 429 — the retry/backoff engine is kept and the network call is
  injected (``push_fn``), so the module itself never reaches the hub.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def filter_corrupted_records(
    records: Sequence[Dict[str, Any]], check_videos: bool = True
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Drop records whose media is missing/corrupt. Returns (kept, dropped)."""
    from avsl_tpu_torch.data.video_io import validate_video

    kept, dropped = [], []
    for rec in records:
        ok = True
        audio = rec.get("audio")
        if audio and not os.path.exists(audio):
            ok = False
        if ok and check_videos:
            for key in ("video", "lip_video"):
                path = rec.get(key)
                if path:
                    valid, _ = validate_video(path)
                    if not valid:
                        ok = False
                        break
        (kept if ok else dropped).append(rec)
    return kept, dropped


def av_to_hf_dataset(
    records: Sequence[Dict[str, Any]],
    output_dir: Optional[str] = None,
    sample_rate: int = 16000,
    check_videos: bool = True,
    cast_media: bool = True,
):
    """Records -> datasets.Dataset (optionally saved to disk).

    Records missing media are filtered out first; a ``corruption_report``
    JSON is written next to the dataset when anything was dropped.
    """
    import datasets

    kept, dropped = filter_corrupted_records(records, check_videos)
    if not kept:
        raise ValueError("No valid records after corruption filtering")

    # column set = UNION across records: media keys ('video',
    # 'lip_video') exist only where the media exists, and keying off
    # kept[0] alone would drop those columns (or inject ragged Nones)
    # whenever the first record happens to be audio-only
    keys: List[str] = []
    for r in kept:
        for k in r:
            if k not in keys:
                keys.append(k)
    columns: Dict[str, List[Any]] = {
        k: [r.get(k) for r in kept] for k in keys
    }
    ds = datasets.Dataset.from_dict(columns)
    if cast_media:
        if "audio" in columns:
            # decode=False: the framework's own decode path (native libav
            # module / scipy) reads media, not datasets' torchcodec
            ds = ds.cast_column(
                "audio", datasets.Audio(sampling_rate=sample_rate, decode=False)
            )
        # video columns intentionally stay as path strings: datasets.Video()
        # would decode through torchcodec on item access; this framework's
        # own media path (native libav / cv2) reads the files
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        ds.save_to_disk(output_dir)
        if dropped:
            with open(os.path.join(output_dir, "corruption_report.json"), "w") as f:
                json.dump(
                    {"dropped": [r.get("id", "?") for r in dropped],
                     "n_kept": len(kept), "n_dropped": len(dropped)},
                    f, indent=2,
                )
    return ds


def av_to_hf_dataset_with_shards(
    records: Sequence[Dict[str, Any]],
    output_dir: str,
    num_shards: int = 8,
    check_videos: bool = True,
) -> Dict[str, Any]:
    """Sharded layout: ``{output_dir}/data/shard_NNNN/metadata.jsonl`` with
    round-robin record assignment + a global ``index.csv``.

    Returns a manifest dict {shards: [...], n_records, csv}.
    """
    kept, dropped = filter_corrupted_records(records, check_videos)
    data_dir = os.path.join(output_dir, "data")
    os.makedirs(data_dir, exist_ok=True)

    shard_paths = []
    writers = []
    for s in range(num_shards):
        sdir = os.path.join(data_dir, f"shard_{s:04d}")
        os.makedirs(sdir, exist_ok=True)
        shard_paths.append(sdir)
        writers.append(open(os.path.join(sdir, "metadata.jsonl"), "w"))

    csv_path = os.path.join(output_dir, "index.csv")
    fieldnames = sorted({k for r in kept for k in r})
    with open(csv_path, "w", newline="") as cf:
        cw = csv.DictWriter(cf, fieldnames=fieldnames + ["shard"])
        cw.writeheader()
        for i, rec in enumerate(kept):
            shard = i % num_shards
            writers[shard].write(json.dumps(rec) + "\n")
            row = dict(rec)
            row["shard"] = shard
            cw.writerow(row)
    for w in writers:
        w.close()

    manifest = {
        "shards": shard_paths,
        "n_records": len(kept),
        "n_dropped": len(dropped),
        "csv": csv_path,
    }
    with open(os.path.join(output_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_sharded_records(output_dir: str) -> List[Dict[str, Any]]:
    """Read back every record from a sharded layout (round-robin order)."""
    with open(os.path.join(output_dir, "manifest.json")) as f:
        manifest = json.load(f)
    per_shard = []
    for sdir in manifest["shards"]:
        with open(os.path.join(sdir, "metadata.jsonl")) as f:
            per_shard.append([json.loads(l) for l in f if l.strip()])
    out = []
    i = 0
    while True:
        emitted = False
        for shard in per_shard:
            if i < len(shard):
                out.append(shard[i])
                emitted = True
        if not emitted:
            break
        i += 1
    return out


def split_dataset(
    records: Sequence[Dict[str, Any]],
    output_dir: Optional[str] = None,
    train_frac: float = 0.7,
    val_frac: float = 0.1,
    seed: int = 0,
    check_videos: bool = False,
):
    """70/10/20 train/val/test split, optionally saved to disk as three HF
    datasets (reference utils/data_loading.py:68-94)."""
    import numpy as np

    idx = np.random.default_rng(seed).permutation(len(records))
    n_train = int(len(records) * train_frac)
    n_val = int(len(records) * val_frac)
    splits = {
        "train": [records[i] for i in idx[:n_train]],
        "val": [records[i] for i in idx[n_train : n_train + n_val]],
        "test": [records[i] for i in idx[n_train + n_val :]],
    }
    if output_dir:
        out = {}
        for name, recs in splits.items():
            if recs:
                out[name] = av_to_hf_dataset(
                    recs, os.path.join(output_dir, name), check_videos=check_videos
                )
        return out
    return splits


def push_dataset_to_hub(
    push_fn: Callable[[], Any],
    max_retries: int = 6,
    base_delay: float = 2.0,
    sleep: Callable[[float], None] = time.sleep,
    is_rate_limit: Optional[Callable[[Exception], bool]] = None,
) -> Any:
    """Run ``push_fn`` with 429-aware exponential backoff.

    The network call is injected (``push_fn``); the retry policy matches the reference (exponential doubling, rate-limit
    errors retried, other errors re-raised — huggingface_utils.py:304-349).
    """
    if is_rate_limit is None:
        is_rate_limit = lambda e: "429" in str(e) or "rate" in str(e).lower()  # noqa: E731
    delay = base_delay
    for attempt in range(max_retries):
        try:
            return push_fn()
        except Exception as e:  # noqa: BLE001
            if attempt == max_retries - 1 or not is_rate_limit(e):
                raise
            sleep(delay)
            delay *= 2
    raise RuntimeError("unreachable")
