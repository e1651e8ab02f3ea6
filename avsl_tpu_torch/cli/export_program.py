"""Export the serving programs with their weights embedded
(``infer/export.py``).

    python -m avsl_tpu_torch.cli.export_program --config cfg.yaml \\
        --ckpt_dir ckpts/flagship --output serving/model --platforms cuda

Port of ``avsl_tpu/cli/export_program.py``, with ``torch.export`` in place
of ``jax.export``. The artifact (the directory ``--output`` and
``--output.json``) holds the log-mel -> encode -> decode-cache program and
one decode step for each platform asked for; ``avsl_tpu_torch.infer.
load_exported`` replays it without model code. ``--platforms`` takes
``cuda`` and/or ``cpu``: a program runs where it was traced, so the
transcriber is built and its programs traced on each in turn; anything
else raises, and so does ``cuda`` without a card. The serving options
(``--beam``, ``--quantize``, ``--kv_int8``, ``--draft_model``/
``--draft_ckpt``/``--spec_k``) are embedded as ``cli/transcribe.py`` takes
them. ``--smoke`` exports the tiny
test model at 1 s windows with random weights; otherwise ``--ckpt_dir`` is
required (an exported program freezes its weights).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--platforms", default="cuda", help="comma list of 'cuda' and 'cpu'")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--quantize", default=None, choices=["int8"])
    p.add_argument("--kv_int8", action="store_true")
    p.add_argument("--draft_model", default=None)
    p.add_argument("--draft_ckpt", default=None)
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)

    from avsl_tpu_torch.cli._serving_common import build_transcriber
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.infer.export import check_platforms, export_serving_program

    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    check_platforms(platforms)
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if args.smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000
    if not args.smoke and not args.ckpt_dir:
        raise SystemExit("--ckpt_dir required (or --smoke): an exported program freezes "
                         "its weights")
    total = 0
    for platform in platforms:
        args.device = platform
        manifest = export_serving_program(build_transcriber(args, cfg), args.output, [platform])
        total += manifest["bytes"]
    manifest.update(platforms=platforms, bytes=total)
    with open(args.output + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"exported {manifest['bytes'] / 1e6:.1f} MB for platforms={manifest['platforms']} "
          f"-> {args.output}")
    return manifest


if __name__ == "__main__":
    main()
