"""Evaluation entry point of the port: WER/CER of a trained checkpoint on
a dataset.

Usage: ``python -m avsl_tpu_torch.cli.evaluate --config cfg.yaml
[--ckpt_dir ...] [--beam N] [--max_new_tokens 64] [--smoke] [--device
cuda|cpu]``

Port of ``avsl_tpu/cli/evaluate.py``, with both of its modes: the
teacher-forced argmax evaluation with its loss (``evaluate_wer``), and with
``--beam N`` the KV-cached batched beam search (the audio and video are
encoded once a batch, the decode cache built for ``max_new + 6`` tokens,
then ``beam_search`` over the cached decoder). Batches of
``eval_batch_size`` items are taken in order and a last partial batch is
dropped, as JAX's ``range(0, len(ds) - bs + 1, bs)`` drops it. ``main``
builds the model as ``cli/finetune.py`` does, restores ``--ckpt_dir``
(the latest step) and calls :func:`evaluate`; a caller with a model in
memory calls :func:`evaluate` itself. Without ``--smoke`` the rows are the
test split that ``cli/finetune.py::load_datasets`` finds; ``--smoke`` is the
fp32 tiny test model on four synthetic rows. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def eval_batches(ds, collator, batch_size: int) -> Iterator[Dict[str, Any]]:
    """Collated batches of ``batch_size`` items of ``ds`` in order; a last
    partial batch is dropped."""
    for i in range(0, len(ds) - batch_size + 1, batch_size):
        yield collator([ds[j] for j in range(i, i + batch_size)])


@torch.inference_mode()
def beam_decode_batch(model, batch: Dict[str, Any], prompt, beam: int, max_new: int,
                      eot: int) -> torch.Tensor:
    """One batch's best beam sequences [B, max_new]: the towers encode the
    audio (and video) once, the decode cache holds ``max_new + 6`` tokens,
    and ``beam_search`` runs over the cached decoder, whose audio and video
    K/V ride the (beam-tiled) cache."""
    from avsl_tpu_torch.decode.beam import beam_search
    from avsl_tpu_torch.train.loop import batch_to_device

    b = batch_to_device(batch, model.device)
    feats, xv = model.encode(b["input_ids"], b.get("video"))
    cache = model.init_decode_cache(feats, xv, max_new + 6)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=model.device)
    seqs, _ = beam_search(lambda tok, c: model.decode(tok, None, None, c), cache, prompt,
                          beam, max_new, eot)
    return seqs


def evaluate(cfg, model, tokenizer, rows, beam: int = 0, max_new_tokens: int = 64,
             wrap_dataset: Optional[Callable[[Any], Any]] = None) -> Dict[str, float]:
    """``test/*`` metrics of ``model`` on ``rows``: teacher-forced WER/CER
    and loss, and with ``beam > 0`` the beam search's ``test/wer_beam`` and
    ``test/cer_beam`` at ``min(max_new_tokens, n_text_ctx - 6)`` new
    tokens. ``wrap_dataset`` (optional) wraps the dataset built from
    ``rows`` before batching. The model runs in eval mode and is put back
    in the mode it came in."""
    from avsl_tpu_torch.data.runtime import AmiVideoDataset, WhisperVideoCollator
    from avsl_tpu_torch.decode import normalize_text, wer_cer
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.runner import evaluate_wer

    w_cfg = model.cfg
    ds = AmiVideoDataset(rows, tokenizer, audio_max_length=int(cfg.audio_max_length),
                         n_mels=w_cfg.n_mels, lang=cfg.lang,
                         load_video=bool(cfg.add_gated_x_attn))
    if wrap_dataset is not None:
        ds = wrap_dataset(ds)
    collator = WhisperVideoCollator(eot_id=tokenizer.eot, max_label_len=w_cfg.n_text_ctx)
    bs = int(cfg.eval_batch_size)

    @torch.inference_mode()
    def eval_logits(batch):
        b = batch_to_device(batch, model.device)
        return model(b["input_ids"], b["dec_input_ids"], video=b.get("video"))

    was_training = model.training
    model.eval()
    try:
        results = evaluate_wer(eval_logits, eval_batches(ds, collator, bs), tokenizer,
                               prefix="test")
        if beam > 0:
            special = tokenizer.special_token_set
            max_new = min(max_new_tokens, w_cfg.n_text_ctx - 6)
            sot = np.asarray(tokenizer.sot_sequence(cfg.lang), np.int64)
            hyps, refs = [], []
            for batch in eval_batches(ds, collator, bs):
                prompt = np.tile(sot[None], (batch["input_ids"].shape[0], 1))
                seqs = beam_decode_batch(model, batch, prompt, beam, max_new, tokenizer.eot)
                for o_row, l_row in zip(seqs.cpu().numpy(), batch["labels"]):
                    o_ids = [int(t) for t in o_row if int(t) not in special]
                    l_ids = [int(t) for t in l_row if int(t) >= 0 and int(t) not in special]
                    hyps.append(normalize_text(tokenizer.decode(o_ids)))
                    refs.append(normalize_text(tokenizer.decode(l_ids)))
            wer, cer = wer_cer(hyps, refs)
            results["test/wer_beam"] = wer
            results["test/cer_beam"] = cer
    finally:
        model.train(was_training)
    return results


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from avsl_tpu_torch.cli.finetune import build_model
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.train.checkpoints import latest_step, restore_checkpoint
    from avsl_tpu_torch.train.loop import TrainState
    from avsl_tpu_torch.train.optim import select_optimizer

    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--beam", type=int, default=0, help="0 = teacher-forced only")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if args.smoke:
        cfg.model_name = "test"
        cfg.audio_max_length = 16000
        cfg.eval_batch_size = 4

    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, _ = build_model(cfg, tokenizer, device, smoke=args.smoke)

    if args.smoke:
        from avsl_tpu_torch.cli.finetune import make_synthetic_dataset

        rows = make_synthetic_dataset(4)
    else:
        from avsl_tpu_torch.cli.finetune import load_datasets

        _, _, rows = load_datasets(cfg)
        if rows is None:
            raise FileNotFoundError("no test dataset found")

    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tx, _ = select_optimizer(model, cfg, 1)
        state = restore_checkpoint(args.ckpt_dir, TrainState.create(model, tx))
        print(f"restored checkpoint step {int(state.step)}")

    results = evaluate(cfg, model, tokenizer, rows, args.beam, args.max_new_tokens)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
