"""Feature-extraction CLI of the port: media -> AV-HuBERT encoder features
(.npy).

``python -m avsl_tpu_torch.cli.extract --csv segs.csv --output feats/
[--layer K] [--config card.yaml] [--ckpt_dir ...] [--device cuda|cpu]`` or
single-item ``--audio seg.wav [--video seg-lip.mp4]``.

Port of ``avsl_tpu/cli/extract.py``, the fairseq ``dump_hubert_feature``
counterpart: the 104-dim stacked-logfbank (+ lip clip) frontends and the
fusion encoder, one ``[T, hidden]`` float32 array per segment.
``--layer K`` taps transformer layer K (1-indexed, before the final
LayerNorm: fairseq ``extract_features(output_layer=k)``); the default taps
the full encoder output. Frame counts are padded to ``--bucket``
multiples (one attention launch shape per bucket) with no padding mask,
as in JAX: real frames attend to the pad frames too; the pad frames are
stripped before writing. Without ``--ckpt_dir`` the weights are random
(seed 0; the JAX CLI's are flax's init, so the two differ).

Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    p = argparse.ArgumentParser()
    p.add_argument("--audio", default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--id", default="0")
    p.add_argument("--csv", default=None)
    p.add_argument("--config", default=None, help="AV-HuBERT model card YAML")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--output", required=True, help="directory for {id}.npy")
    p.add_argument("--layer", type=int, default=None,
                   help="1-indexed transformer tap; default: encoder output")
    p.add_argument("--bucket", type=int, default=32)
    p.add_argument("--tiny", action="store_true", help="tiny_test card (CI)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from avsl_tpu_torch.cli._avh_common import (
        load_row_features,
        maybe_restore_variables,
        rows_from_args,
    )
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.models import build_avhubert

    rows = rows_from_args(args)
    if args.tiny:
        cfg = AVHuBERTConfig.tiny_test()
    elif args.config:
        cfg = AVHuBERTConfig.from_yaml(args.config)
    else:
        cfg = AVHuBERTConfig()
    device = resolve_device(args.device)
    model = None

    os.makedirs(args.output, exist_ok=True)
    results: List[Dict[str, Any]] = []
    for row in rows:
        pad_a, pad_v, t = load_row_features(row, args.bucket, device=device)
        if model is None:
            model = maybe_restore_variables(args.ckpt_dir,
                                            build_avhubert(cfg, "encoder", device=device))
        with torch.no_grad():
            feats = model.extract_features(audio=torch.from_numpy(pad_a).to(device),
                                           video=torch.from_numpy(pad_v).to(device),
                                           output_layer=args.layer)
        feats = feats.float().cpu().numpy()[0, :t]
        out_path = os.path.join(args.output, f"{row['id']}.npy")
        np.save(out_path, feats)
        results.append({"id": row["id"], "path": out_path, "shape": list(feats.shape)})

    print(json.dumps({
        "n": len(results),
        "hidden": results[0]["shape"][1] if results else 0,
        "layer": args.layer,
        "output": args.output,
    }))
    return results


if __name__ == "__main__":
    main()
