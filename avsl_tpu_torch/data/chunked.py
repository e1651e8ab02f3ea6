"""Chunked, checkpointed batch orchestration (L3).

Port of ``avsl_tpu/data/chunked.py``. Parity with the reference's
resilience machinery (preprocess/process_in_chunks.py +
laugh_dataset_process.py:609-878): work is split into chunks; each chunk completion writes
a JSON checkpoint (plus per-item granularity inside a chunk — the
reference's ``last_video_processed``); interrupted runs resume from the
checkpoint; chunk status marker files ``_COMPLETED`` / ``_FAILED`` are
dropped per chunk; results are merged back into the driving CSV in place.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class ChunkCheckpoint:
    chunk_index: int = 0
    last_item_processed: int = -1  # within-chunk granularity
    completed_chunks: List[int] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = 0.0
    # the chunk size the indices were written under: resuming with a
    # DIFFERENT --chunk_size must remap (old run at size 50, chunk 1 =
    # item 50; naively resumed at size 200 it would mean item 200,
    # silently skipping 50-199). 0 = unknown (older checkpoints).
    chunk_size: int = 0

    def items_done(self) -> int:
        """Completed item count implied by this checkpoint (requires
        chunk_size > 0)."""
        done = self.chunk_index * self.chunk_size
        if self.last_item_processed >= 0:
            done += self.last_item_processed + 1
        return done

    def to_dict(self) -> Dict[str, Any]:
        return {
            "chunk_index": self.chunk_index,
            "last_item_processed": self.last_item_processed,
            "completed_chunks": self.completed_chunks,
            "stats": self.stats,
            "timestamp": self.timestamp,
            "chunk_size": self.chunk_size,
        }


def checkpoint_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "chunk_checkpoint.json")


def save_checkpoint(checkpoint_dir: str, ckpt: ChunkCheckpoint) -> str:
    os.makedirs(checkpoint_dir, exist_ok=True)
    ckpt.timestamp = time.time()
    path = checkpoint_path(checkpoint_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ckpt.to_dict(), f, indent=2)
    os.replace(tmp, path)  # atomic
    return path


def find_checkpoint(checkpoint_dir: str) -> Optional[ChunkCheckpoint]:
    path = checkpoint_path(checkpoint_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return ChunkCheckpoint(
        chunk_index=d.get("chunk_index", 0),
        last_item_processed=d.get("last_item_processed", -1),
        completed_chunks=d.get("completed_chunks", []),
        stats=d.get("stats", {}),
        timestamp=d.get("timestamp", 0.0),
        chunk_size=d.get("chunk_size", 0),
    )


def prepare_chunks(items: Sequence[Any], chunk_size: int) -> List[List[Any]]:
    return [list(items[i : i + chunk_size]) for i in range(0, len(items), chunk_size)]


def mark_chunk(output_dir: str, chunk_index: int, ok: bool) -> None:
    os.makedirs(output_dir, exist_ok=True)
    marker = "_COMPLETED" if ok else "_FAILED"
    open(os.path.join(output_dir, f"chunk_{chunk_index:04d}{marker}"), "w").close()


def chunk_status(output_dir: str, chunk_index: int) -> Optional[bool]:
    if os.path.exists(os.path.join(output_dir, f"chunk_{chunk_index:04d}_COMPLETED")):
        return True
    if os.path.exists(os.path.join(output_dir, f"chunk_{chunk_index:04d}_FAILED")):
        return False
    return None


def _resume_position(ckpt: Optional[ChunkCheckpoint], chunk_size: int):
    """(start_chunk, start_item) under the CURRENT chunk_size. When the
    checkpoint was written under a different size, remap through the
    completed item count (floor: a partially-overlapping chunk is safely
    re-processed rather than skipped)."""
    if ckpt is None:
        return 0, 0
    if ckpt.chunk_size in (0, chunk_size):
        return ckpt.chunk_index, ckpt.last_item_processed + 1
    done = ckpt.items_done()
    return done // chunk_size, 0


def process_in_chunks(
    items: Sequence[Any],
    process_item: Callable[[Any], Tuple[bool, Any]],
    checkpoint_dir: str,
    chunk_size: int = 100,
    resume: bool = True,
    checkpoint_every: int = 10,
    on_chunk_done: Optional[Callable[[int, List[Tuple[bool, Any]]], None]] = None,
) -> Dict[str, Any]:
    """Run ``process_item`` over all items with chunk+item-level resume.

    Returns {results: [(ok, payload)...] aligned to items (None for items
    skipped by resume), n_ok, n_failed, resumed_from}.
    """
    chunks = prepare_chunks(items, chunk_size)
    ckpt = find_checkpoint(checkpoint_dir) if resume else None
    start_chunk, start_item = _resume_position(ckpt, chunk_size)
    resumed_from = (start_chunk, start_item) if ckpt else None

    results: List[Optional[Tuple[bool, Any]]] = [None] * len(items)
    n_ok = n_failed = 0

    for ci in range(start_chunk, len(chunks)):
        chunk = chunks[ci]
        first_item = start_item if ci == start_chunk else 0
        chunk_results: List[Tuple[bool, Any]] = []
        chunk_ok = True
        for ii in range(first_item, len(chunk)):
            global_idx = ci * chunk_size + ii
            try:
                ok, payload = process_item(chunk[ii])
            except Exception as e:  # noqa: BLE001
                ok, payload = False, str(e)
            results[global_idx] = (ok, payload)
            chunk_results.append((ok, payload))
            n_ok += int(ok)
            n_failed += int(not ok)
            chunk_ok &= ok
            if (ii + 1) % checkpoint_every == 0:
                save_checkpoint(
                    checkpoint_dir,
                    ChunkCheckpoint(
                        chunk_size=chunk_size,
                        chunk_index=ci,
                        last_item_processed=ii,
                        completed_chunks=list(range(ci)),
                        stats={"n_ok": n_ok, "n_failed": n_failed},
                    ),
                )
        mark_chunk(checkpoint_dir, ci, chunk_ok)
        if on_chunk_done:
            on_chunk_done(ci, chunk_results)
        save_checkpoint(
            checkpoint_dir,
            ChunkCheckpoint(
                chunk_size=chunk_size,
                chunk_index=ci + 1,
                last_item_processed=-1,
                completed_chunks=list(range(ci + 1)),
                stats={"n_ok": n_ok, "n_failed": n_failed},
            ),
        )
    return {
        "results": results,
        "n_ok": n_ok,
        "n_failed": n_failed,
        "resumed_from": resumed_from,
    }


def _pool_worker_init() -> None:
    """Workers ignore SIGINT so the parent handles interrupts (the
    reference's worker convention, video_process.py:669-673)."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)


class _GuardedItem:
    """Picklable per-item exception guard for pool workers: one corrupt
    item must yield (False, error) — an uncaught raise kills the whole
    pool.map BEFORE the chunk checkpoint, so every resume would replay
    the same chunk into the same crash."""

    def __init__(self, fn: Callable[[Any], Tuple[bool, Any]]):
        self.fn = fn

    def __call__(self, item):
        try:
            return self.fn(item)
        except Exception as e:  # noqa: BLE001
            return False, f"{type(e).__name__}: {e}"


def process_chunks_with_multiprocessing(
    items: Sequence[Any],
    process_item: Callable[[Any], Tuple[bool, Any]],
    checkpoint_dir: str,
    chunk_size: int = 100,
    num_workers: int = 4,
    maxtasksperchild: int = 10,
    resume: bool = True,
) -> Dict[str, Any]:
    """Chunked processing with a worker pool per chunk (chunk-level resume).

    Mirrors the reference's Pool(num_workers, maxtasksperchild) driver
    (video_process.py:777-812, process_in_chunks.py:406-).

    The workers are started with ``spawn`` (JAX's pool forks): a forked
    worker of a process that has initialised CUDA cannot use the card,
    while a spawned one is a fresh interpreter that initialises CUDA
    itself if its item needs the card. So ``process_item`` must be
    picklable by reference (a module-level function), and the parent's
    state reaches the workers only through the items."""
    chunks = prepare_chunks(items, chunk_size)
    ckpt = find_checkpoint(checkpoint_dir) if resume else None
    start_chunk, _ = _resume_position(ckpt, chunk_size)
    results: List[Optional[Tuple[bool, Any]]] = [None] * len(items)
    n_ok = n_failed = 0

    worker = _GuardedItem(process_item)
    ctx = mp.get_context("spawn")
    for ci in range(start_chunk, len(chunks)):
        chunk = chunks[ci]
        with ctx.Pool(
            num_workers, initializer=_pool_worker_init,
            maxtasksperchild=maxtasksperchild,
        ) as pool:
            chunk_results = pool.map(worker, chunk)
        chunk_ok = True
        for ii, (ok, payload) in enumerate(chunk_results):
            results[ci * chunk_size + ii] = (ok, payload)
            n_ok += int(ok)
            n_failed += int(not ok)
            chunk_ok &= ok
        mark_chunk(checkpoint_dir, ci, chunk_ok)
        save_checkpoint(
            checkpoint_dir,
            ChunkCheckpoint(
                chunk_size=chunk_size,
                chunk_index=ci + 1,
                completed_chunks=list(range(ci + 1)),
                stats={"n_ok": n_ok, "n_failed": n_failed},
            ),
        )
    return {"results": results, "n_ok": n_ok, "n_failed": n_failed,
            "resumed_from": (start_chunk, 0) if ckpt else None}


def update_csv_with_results(
    csv_path: str,
    results: Dict[str, Dict[str, Any]],
    key_column: str = "id",
) -> int:
    """Merge per-item result columns back into the driving CSV in place
    (process_in_chunks.py:189-233). Returns rows updated."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    new_cols = sorted({c for r in results.values() for c in r})
    for c in new_cols:
        if c not in df.columns:
            df[c] = None
    updated = 0
    for idx, row in df.iterrows():
        key = str(row[key_column])
        if key in results:
            for c, v in results[key].items():
                df.at[idx, c] = v
            updated += 1
    df.to_csv(csv_path, index=False)
    return updated
