"""Shared host-side prep for the AV-HuBERT tooling CLIs of the port
(``cli.align``, ``cli.extract``).

Port of ``avsl_tpu/cli/_avh_common.py``: CSV or single-item row intake,
the 104-dim stacked-logfbank (+ lip clip) feature load with
truncate-to-min alignment, frame-bucket padding (one launch shape per
bucket, as the JAX CLIs compile once per bucket) in numpy on the host,
and the optimizer-agnostic checkpoint restore
(``train/checkpoints.py::restore_params_only``: the writer's optimizer
state is never read). The filterbank runs on ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

CROP = 88


def rows_from_args(args) -> List[Dict[str, Any]]:
    """``--csv path`` (columns id, audio, [video], ...) or single-item
    ``--audio [--video] [--id]``."""
    if getattr(args, "csv", None):
        import csv as _csv

        with open(args.csv, newline="") as f:
            rows = list(_csv.DictReader(f))
        for i, r in enumerate(rows):
            r.setdefault("id", str(i))
        return rows
    if getattr(args, "audio", None):
        row: Dict[str, Any] = {"id": getattr(args, "id", "0"), "audio": args.audio}
        if getattr(args, "video", None):
            row["video"] = args.video
        return [row]
    raise SystemExit("need --audio or --csv")


def load_row_features(
    row: Dict[str, Any], bucket: int, crop: int = CROP, device: Union[str, Any] = "cuda"
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row -> (padded_audio_feats [1,Tb,104], padded_video [1,Tb,c,c,1],
    true_frames). Audio may be a wav path or a PCM array; video (a lip
    clip path) is truncate-to-min aligned with the audio frames; a row
    without one gets a zero clip. The features are made on ``device`` and
    padded on the host."""
    from avsl_tpu_torch.data.audio_segments import load_wav
    from avsl_tpu_torch.kernels.fbank import avhubert_audio_features

    audio = row["audio"]
    audio = load_wav(audio) if isinstance(audio, str) else np.asarray(audio, np.float32)
    feats_a = avhubert_audio_features(audio, device=device).cpu().numpy()
    path = row.get("video")
    if path:
        from avsl_tpu_torch.data.video_io import load_video_feats

        feats_v = load_video_feats(path, image_crop_size=crop)
        t = min(len(feats_a), len(feats_v))
        feats_a, feats_v = feats_a[:t], feats_v[:t]
    else:
        feats_v = np.zeros((len(feats_a), crop, crop, 1), np.float32)
    t = len(feats_a)
    tb = max(((t + bucket - 1) // bucket) * bucket, bucket)
    pad_a = np.zeros((1, tb, feats_a.shape[-1]), np.float32)
    pad_a[0, :t] = feats_a
    pad_v = np.zeros((1, tb, crop, crop, 1), np.float32)
    pad_v[0, :t] = feats_v
    return pad_a, pad_v, t


def maybe_restore_variables(ckpt_dir: Optional[str], model):
    """Load the newest checkpoint's parameters and BatchNorm statistics
    under ``ckpt_dir`` into ``model`` (strictly: every key, no other) when
    a directory is given; optimizer-structure agnostic. Raises SystemExit
    when the directory holds no checkpoint. Returns the model."""
    if not ckpt_dir:
        return model
    from avsl_tpu_torch.train.checkpoints import restore_params_only

    loaded = restore_params_only(ckpt_dir)
    if loaded is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir!r}")
    model.load_state_dict(loaded, strict=True)
    return model
