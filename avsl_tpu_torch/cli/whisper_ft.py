"""Audio-only Whisper fine-tuning entry point of the port.

Usage: ``python -m avsl_tpu_torch.cli.whisper_ft [--config cfg.yaml]
--do_train --do_eval [--device cuda|cpu]`` (or ``--smoke``).

Port of ``avsl_tpu/cli/whisper_ft.py``: ``<laugh>`` token added and the
vocab sized to the tokenizer, -100 label masking via the collator,
teacher-forced WER validation, beam-search eval (beam 4, max length 448),
last-checkpoint resume and ``results.json``, through the port's
``TrainerRunner``. The weights are fp32 and the compute bf16 (fp32 with
``--smoke``). Differences from the JAX entry point:

* a train batch holds ``batch_size × gradient_accumulation_steps`` items,
  reshaped to ``[accum, batch_size, ...]`` (the reference trainer's
  accumulate-grad-batches semantics, as ``avsl_tpu/cli/finetune.py``
  builds its batches). The JAX entry point yields batches of
  ``batch_size`` items, so with the config's batch 1 × accumulation 16
  its runner drops every batch and never takes a step;
* the loss applies ``cfg.spec_augment`` (the config's "ls-basic"); the JAX
  entry point passes none;
* ``--smoke`` trains with batch 1 × accumulation 2 (JAX: 4 × 1), so it
  exercises the accumulation;
* real datasets (``load_datasets``) wait for the host data layer
  (ROADMAP.md queue 1, item 13) and raise: only ``--smoke`` has data.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


def build_model(cfg, tokenizer, device, smoke: bool = False,
                vocab_size: Optional[int] = None, seed: int = 0):
    """The audio-only Whisper for ``cfg`` on ``device``, fp32 weights, with
    ``<laugh>`` added to ``tokenizer`` and the vocab sized to it (or to
    ``vocab_size`` when that is larger, e.g. a preset's full vocab over
    the offline byte tokenizer). Returns ``(model, w_cfg)``."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    vocab = tokenizer.add_tokens(["<laugh>"])
    if vocab_size is not None:
        if vocab_size < vocab:
            raise ValueError(f"vocab_size {vocab_size} < the tokenizer's {vocab}")
        vocab = vocab_size
    return build_whisper_flamingo(
        cfg.model_name, vocab_size=vocab, add_gated_x_attn=0,
        use_av_hubert_encoder=False, dropout_rate=cfg.dropout_rate,
        dtype="float32" if smoke else "bfloat16", param_dtype="float32",
        device=device, seed=seed,
    )


def make_dataset(rows, tokenizer, cfg, w_cfg):
    from avsl_tpu_torch.data.runtime import AmiVideoDataset

    return AmiVideoDataset(
        rows, tokenizer, audio_max_length=int(cfg.audio_max_length),
        n_mels=w_cfg.n_mels, lang=cfg.lang, load_video=False,
    )


def batches(ds, collator, bs: int, shuffle: bool, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Collated batches of ``bs`` items (the last partial batch dropped),
    shuffled per epoch with a seeded order."""
    order = np.arange(len(ds))
    if shuffle:
        order = np.random.default_rng(epoch).permutation(order)
    for i in range(0, len(order) - bs + 1, bs):
        yield collator([ds[int(j)] for j in order[i: i + bs]])


def make_runner(cfg, model, tokenizer, output_dir: str, seed: int = 0):
    """``TrainerRunner`` over ``flamingo_loss_fn`` (dropout, the config's
    SpecAugment) and ``whisper_optimizer`` (all parameters, AdamW)."""
    from avsl_tpu_torch.train.loop import TrainState, batch_to_device
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn
    from avsl_tpu_torch.train.optim import whisper_optimizer
    from avsl_tpu_torch.train.runner import TrainerRunner

    tx, _ = whisper_optimizer(model, cfg, int(cfg.num_train_steps))
    state = TrainState.create(model, tx, seed=seed)

    @torch.no_grad()
    def eval_logits(state, batch):
        state.model.eval()
        b = batch_to_device(batch, state.model.device)
        return state.model(b["input_ids"], b["dec_input_ids"])

    return TrainerRunner(
        flamingo_loss_fn(model, train=True, spec_augment=cfg.spec_augment),
        eval_logits, tx, state, tokenizer, cfg,
        log_dir=os.path.join(output_dir, "logs"),
        ckpt_dir=os.path.join(output_dir, "ckpt"),
    )


@torch.inference_mode()
def beam_eval(model, tokenizer, batch_iter, lang: str, num_beams: int, max_new: int):
    """Beam-search decode every batch; ``(wer, cer, n)`` against the labels."""
    from avsl_tpu_torch.decode import normalize_text, wer_cer
    from avsl_tpu_torch.decode.beam import beam_search

    model.eval()
    hyps, refs = [], []
    special = tokenizer.special_token_set
    sot = np.asarray(tokenizer.sot_sequence(lang), np.int64)
    for batch in batch_iter:
        mel = torch.as_tensor(batch["input_ids"], device=model.device)
        feats, _ = model.encode(mel)
        cache = model.init_decode_cache(feats, None, max_new + 5)
        prompt = torch.as_tensor(np.tile(sot[None], (mel.shape[0], 1)), device=model.device)
        seqs, _ = beam_search(lambda tok, c: model.decode(tok, None, None, c), cache, prompt,
                              beam_size=num_beams, max_new_tokens=max_new, eot_id=tokenizer.eot)
        for o_row, l_row in zip(seqs.cpu().numpy(), batch["labels"]):
            o_ids = [int(t) for t in o_row if int(t) not in special]
            l_ids = [int(t) for t in l_row if int(t) >= 0 and int(t) not in special]
            hyps.append(normalize_text(tokenizer.decode(o_ids)))
            refs.append(normalize_text(tokenizer.decode(l_ids)))
    wer, cer = wer_cer(hyps, refs)
    return wer, cer, len(hyps)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.runtime import WhisperVideoCollator
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--num_beams", type=int, default=4)
    p.add_argument("--max_eval_tokens", type=int, default=448)
    p.add_argument("--output_dir", default="output/whisper_ft")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    cfg.add_gated_x_attn = 0  # audio-only
    cfg.use_av_hubert_encoder = False
    if getattr(cfg, "early_stop_patience", None) is None:
        # the reference's EarlyStoppingCallback(early_stopping_patience=5)
        # when the config does not set it; an explicit 0 disables it
        cfg.early_stop_patience = 5
    if args.smoke:
        args.do_train = args.do_eval = True
        cfg.model_name = "test"
        cfg.num_train_steps = 4
        cfg.validate_every_n_batches = 100
        cfg.gradient_accumulation_steps = 2
        cfg.batch_size = 1
        cfg.audio_max_length = 16000
        cfg.warmup_steps = 1

    if not args.smoke:
        raise NotImplementedError(
            "load_datasets: real datasets wait for the host data layer "
            "(ROADMAP.md queue 1, item 13); run with --smoke"
        )
    from avsl_tpu_torch.cli.finetune import make_synthetic_dataset

    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, w_cfg = build_model(cfg, tokenizer, device, smoke=args.smoke)

    train_ds = make_dataset(make_synthetic_dataset(8), tokenizer, cfg, w_cfg)
    eval_ds = make_dataset(make_synthetic_dataset(4), tokenizer, cfg, w_cfg)
    collator = WhisperVideoCollator(
        eot_id=tokenizer.eot, max_label_len=min(args.max_eval_tokens, w_cfg.n_text_ctx),
    )
    accum = int(cfg.gradient_accumulation_steps)

    results: Dict[str, Any] = {}
    os.makedirs(args.output_dir, exist_ok=True)
    if args.do_train:
        runner = make_runner(cfg, model, tokenizer, args.output_dir)
        fit = runner.fit(
            train_batches=lambda e: batches(train_ds, collator, int(cfg.batch_size) * accum, True, e),
            val_batches=lambda: batches(eval_ds, collator, int(cfg.eval_batch_size), False),
            num_steps=int(cfg.num_train_steps),
            validate_every=int(cfg.validate_every_n_batches),
        )
        results["train"] = {
            "final_step": fit["final_step"],
            "best_wer": None if fit["best_wer"] == float("inf") else fit["best_wer"],
            "best_step": fit["best_step"],
        }

    if args.do_eval:
        # beam-search decode eval (reference: beam 4 / max length 448)
        max_new = min(args.max_eval_tokens, w_cfg.n_text_ctx) - 5
        wer, cer, n = beam_eval(
            model, tokenizer, batches(eval_ds, collator, int(cfg.eval_batch_size), False),
            cfg.lang, args.num_beams, max_new,
        )
        results["eval"] = {"wer": wer, "cer": cer, "n": n}

    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
