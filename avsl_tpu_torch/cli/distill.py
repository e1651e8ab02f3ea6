"""Distill a speculative-decoding draft model from a trained target.

Usage: ``python -m avsl_tpu_torch.cli.distill --input segs/ --config
cfg.yaml --ckpt_dir ckpts/flagship --draft_model tiny --output ckpts/draft
--steps 2000 [--device cuda|cpu]``

Port of ``avsl_tpu/cli/distill.py`` (``train/distill.py``): the target
(built and restored as the serving CLIs build it,
``cli/_serving_common.py::build_target_with_weights``, and run
audio-only) greedy-decodes each input clip once, the tokens are kept, and
every step then recomputes the target's teacher-forced distribution along
a random batch of them and updates the draft (``--draft_model``'s preset,
audio-only, fp32 weights; bf16 compute, fp32 under ``--smoke``) with
``optax.adamw(lr, weight_decay=0.01)``'s update
(``train/optim.py::constant_adamw``). It writes the draft's checkpoint,
which ``cli.transcribe`` / ``cli.serve --draft_model <preset> --draft_ckpt``
load, and ``distill_summary.json`` (the JAX CLI's keys, plus the label
pass's and the steps' seconds). ``--ckpt_dir`` is required unless
``--smoke`` (the tiny presets, random target weights). Runs on ``cuda``
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="segment dir or CSV (audio)")
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt_dir", default=None, help="target checkpoint")
    p.add_argument("--draft_model", default="tiny")
    p.add_argument("--output", required=True, help="draft checkpoint dir")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--hard_weight", type=float, default=0.5)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--smoke", action="store_true", help="random target weights, test-size models")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    import numpy as np

    from avsl_tpu_torch.cli._serving_common import build_target_with_weights
    from avsl_tpu_torch.cli.transcribe import collect_items
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.audio_segments import load_wav
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.kernels.logmel import pad_or_trim
    from avsl_tpu_torch.models.factory import build_whisper_flamingo
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.distill import make_greedy_label_fn, make_online_distill_step
    from avsl_tpu_torch.train.loop import TrainState
    from avsl_tpu_torch.train.optim import constant_adamw

    device = resolve_device(args.device)
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    smoke = bool(args.smoke)
    if smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000  # the test preset's audio context
    if not smoke and not args.ckpt_dir:
        raise SystemExit("--ckpt_dir required (or --smoke): distilling from "
                         "random target weights produces a useless draft")
    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    b, audio_max = args.batch_size, int(cfg.audio_max_length)
    # the target as trained and served; labelled audio-only (the gated
    # sublayers skipped), as the draft is queried at serve time
    target, t_cfg, _ = build_target_with_weights(cfg, tokenizer, smoke, args.ckpt_dir,
                                                 device=str(device))
    d_name = "test" if smoke else args.draft_model
    draft, _ = build_whisper_flamingo(d_name, vocab_size=t_cfg.n_vocab, add_gated_x_attn=False,
                                      dtype="float32" if smoke else "bfloat16",
                                      param_dtype="float32", device=device, seed=1)

    items = [it for it in collect_items(args.input) if it.get("audio")]
    if not items:
        raise SystemExit("no audio items found")
    clips = np.stack([pad_or_trim(np.asarray(load_wav(it["audio"]), np.float32), audio_max)
                      for it in items])
    prompt = np.tile(np.asarray(tokenizer.sot_sequence(cfg.lang), np.int64)[None], (b, 1))

    # the label pass: one greedy decode per clip, the tokens kept on the
    # host; the steps recompute the target's distribution in one forward
    t0 = time.perf_counter()
    label_fn = make_greedy_label_fn(target, args.max_new_tokens, tokenizer.eot)
    n = len(clips)
    labels = np.zeros((n, prompt.shape[1] + args.max_new_tokens), np.int64)
    for start in range(0, n, b):
        idx = np.arange(start, start + b) % n  # wrap the tail batch
        labels[idx] = label_fn(clips[idx], prompt).cpu().numpy()
    label_seconds = time.perf_counter() - t0
    print(f"labeled {n} clips", flush=True)

    state = TrainState.create(draft, constant_adamw(dict(draft.named_parameters()), args.lr,
                                                    weight_decay=0.01))
    step_fn = make_online_distill_step(target, draft, prompt_len=prompt.shape[1],
                                       eot_id=tokenizer.eot, hard_weight=args.hard_weight)
    rng = np.random.default_rng(0)
    history, metrics = [], {}
    t0 = time.perf_counter()
    for step in range(args.steps):
        idx = rng.integers(0, n, size=b)
        state, metrics = step_fn(state, clips[idx], labels[idx])
        if step % max(args.log_every, 1) == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()), flush=True)
    train_seconds = time.perf_counter() - t0

    save_checkpoint(args.output, state, int(state.step))
    summary = {
        "steps": args.steps,
        "final": {k: float(v) for k, v in metrics.items()},
        "output": args.output,
        "draft_model": d_name,
        "history": history,
        "label_seconds": label_seconds,
        "train_seconds": train_seconds,
    }
    with open(os.path.join(args.output, "distill_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
