"""AV-HuBERT fine-tuning entry point of the port (seq2seq or CTC head).

Usage: ``python -m avsl_tpu_torch.cli.avhubert_ft [--config avhubert.yaml]
[--head seq2seq|ctc] [--steps N] [--smoke] [--device cuda|cpu]``

Port of ``avsl_tpu/cli/avhubert_ft.py``: AV-HuBERT built from the
fairseq-style model card (``configs/avhubert_large.yaml``: 24 encoder
layers of 1024, concat fusion of 104-dim audio features and 88x88 lip
clips, 9 decoder layers of 1024 with 8 heads) or ``AVHuBERTConfig()``,
trained on a synthetic AV batch set (24 frames an item, 3-7 label tokens)
with the label-smoothed seq2seq loss or the CTC loss, modality dropout
and the card's rates; the optimizer is the JAX CLI's: global-norm clip 10,
then AdamW (b1 0.9, b2 0.98, eps 1e-6, weight decay 0.01 on every
parameter) over ``linear_warmup_decay(lr, steps // 10, steps)``. It prints
one JSON line with the JAX CLI's keys (the CTC head adds the best-path
decode of the eval batch). Weights are fp32 and the compute is the card's
dtype (bf16); ``--smoke`` runs the tiny fp32 test model with modality
dropout 0.2 and audio dropout 0.5 for 6 steps.

``--n_experts N`` (with ``--moe_top_k``) puts an N-expert MoE FFN in
every encoder block (:mod:`avsl_tpu_torch.models.moe`) and the result
reports ``n_experts``; its Switch balance loss joins the training loss at
weight 0.01. For the CTC head that is the JAX CLI's own closure
(:func:`cli_ctc_loss_fn`), which adds it whatever its ``train`` flag.

Runs on ``cuda`` unless ``--device cpu``. ``--experts_parallel N`` (N > 1)
trains on the (data, expert) mesh of ``models/moe.py::make_ep_mesh``, and
else ``--model_parallel N`` on the (data, model) mesh, as the JAX CLI
builds them (:func:`cli_mesh`; the expert axis wins when both are above
1), one process a rank: ``python -m torch.distributed.run --standalone
--nproc_per_node W -m avsl_tpu_torch.cli.avhubert_ft --smoke --n_experts 4
--experts_parallel 2 [--device cpu]``, whose world size ``W`` is the JAX
CLI's device count. The result then adds ``mesh`` and ``sharded_params``
(the parameters the rules split) and rank 0 prints it.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from avsl_tpu_torch.utils.spans import span


def make_synthetic_av_batchset(
    n: int, t: int = 24, feat_dim: int = 104, image: int = 24, vocab: int = 59,
    seed: int = 0,
):
    """``n`` rows of seeded audio features [t, feat_dim], lip frames [t,
    image, image, 1] and 3-7 label tokens in [4, vocab - 1)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        length = rng.integers(3, 8)
        labels = rng.integers(4, vocab - 1, length).tolist()
        rows.append(
            {
                "audio_feats": rng.normal(size=(t, feat_dim)).astype(np.float32),
                "video_feats": rng.normal(size=(t, image, image, 1)).astype(np.float32),
                "labels": labels,
            }
        )
    return rows


def collate_av(rows, pad_id: int, max_label_len: int = 16) -> Dict[str, np.ndarray]:
    """Pad rows to one batch: features and lip frames to the longest row
    with ``padding_mask`` (True = a real frame); labels EOS-terminated (id
    2), padded with -100 and cut to ``max_label_len``; ``dec_input_ids``
    the BOS-prefixed (id 0) labels shifted right, padded with ``pad_id``."""
    with span("data.batch"):
        return _collate_av(rows, pad_id, max_label_len)


def _collate_av(rows, pad_id: int, max_label_len: int) -> Dict[str, np.ndarray]:
    b = len(rows)
    t = max(len(r["audio_feats"]) for r in rows)
    feat_dim = rows[0]["audio_feats"].shape[1]
    ih = rows[0]["video_feats"].shape[1]
    audio = np.zeros((b, t, feat_dim), np.float32)
    video = np.zeros((b, t, ih, ih, 1), np.float32)
    pad_mask = np.zeros((b, t), bool)
    lab_len = min(max(len(r["labels"]) + 1 for r in rows), max_label_len)
    labels = np.full((b, lab_len), -100, np.int64)
    dec = np.full((b, lab_len), pad_id, np.int64)
    for i, r in enumerate(rows):
        n = len(r["audio_feats"])
        audio[i, :n] = r["audio_feats"]
        video[i, :n] = r["video_feats"]
        pad_mask[i, :n] = True
        ids = (r["labels"] + [2])[:lab_len]  # eos terminated
        labels[i, : len(ids)] = ids
        dec[i, 0] = 0  # bos
        dec[i, 1 : len(ids)] = ids[:-1]  # shift-right teacher forcing
    return {"audio": audio, "video": video, "padding_mask": pad_mask, "labels": labels,
            "dec_input_ids": dec}


def ctc_batch(batch: Dict[str, np.ndarray], pad_id: int) -> Dict[str, np.ndarray]:
    """The CTC loss's view of a collated batch, as the JAX CLI forms it:
    -100 labels become ``pad_id`` (the blank) with ``label_padding`` 1, and
    ``logit_padding`` is 1 on padded frames."""
    out = {k: v for k, v in batch.items() if k != "dec_input_ids"}
    out["label_padding"] = (batch["labels"] == -100).astype(np.float32)
    out["labels"] = np.where(batch["labels"] == -100, pad_id, batch["labels"])
    out["logit_padding"] = 1.0 - batch["padding_mask"].astype(np.float32)
    return out


def cli_ctc_loss_fn(model, train: bool = True, moe_aux_coef: float = 0.01):
    """The JAX CLI's CTC closure (``avsl_tpu/cli/avhubert_ft.py:154-185``) on
    a :func:`ctc_batch`: the CTC loss plus ``moe_aux_coef`` times the MoE
    balance loss when the encoder has experts, in training and in eval
    alike (``train/objectives.py`` adds it in training only). Returns
    ``loss_fn(batch, generator) -> (loss, {})``."""
    from avsl_tpu_torch.models.avhubert import ctc_loss
    from avsl_tpu_torch.models.intermediates import collect_intermediates
    from avsl_tpu_torch.models.moe import moe_aux_loss

    def loss_fn(batch, generator):
        model.train(train)
        with collect_intermediates() as inter:
            logits = model(audio=batch["audio"], video=batch["video"],
                           padding_mask=batch["padding_mask"],
                           generator=generator if train else None)
        loss = ctc_loss(logits, batch["logit_padding"], batch["labels"], batch["label_padding"],
                        model.cfg.pad_token_id)
        if model.cfg.n_experts > 0:
            loss = loss + moe_aux_coef * moe_aux_loss(inter)
        return loss, {}

    return loss_fn


def make_optimizer(model, lr: float, steps: int):
    """The JAX CLI's optax chain: ``clip_by_global_norm(10)`` then AdamW
    (b1 0.9, b2 0.98, eps 1e-6, weight decay 0.01, no mask) over every
    parameter, on ``linear_warmup_decay(lr, max(steps // 10, 1), steps)``."""
    from avsl_tpu_torch.train.optim import ClippedAdamW, linear_warmup_decay

    return ClippedAdamW(dict(model.named_parameters()),
                        linear_warmup_decay(lr, max(steps // 10, 1), steps),
                        b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01, clip_norm=10.0)


def batches(rows, batch_size: int, pad_id: int, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Full batches of ``rows`` in the order of ``default_rng(epoch)``."""
    order = np.random.default_rng(epoch).permutation(len(rows))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        yield collate_av([rows[j] for j in order[i : i + batch_size]], pad_id)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="fairseq-style model card YAML")
    p.add_argument("--head", choices=("seq2seq", "ctc"), default="seq2seq")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--n_experts", type=int, default=0,
                   help="swap encoder MLPs for a MoE FFN with N experts")
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--experts_parallel", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def cli_mesh(args: argparse.Namespace):
    """The JAX CLIs' mesh (``avsl_tpu/cli/avhubert_ft.py:212-236``,
    ``pretrain.py:182-224``): none unless a flag is above 1; the (data,
    expert) mesh of ``--experts_parallel`` over the launcher's ranks, else
    the (data, model) mesh of ``--model_parallel`` (``--model_parallel`` is
    ignored beside ``--experts_parallel``, as in JAX). Joins the process
    group first (``core/mesh.py::init_distributed``)."""
    if args.experts_parallel <= 1 and args.model_parallel <= 1:
        return None
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.core.mesh import init_distributed, make_mesh
    from avsl_tpu_torch.models.moe import make_ep_mesh

    init_distributed(resolve_device(args.device))
    if args.experts_parallel > 1:
        return make_ep_mesh(experts_parallel=args.experts_parallel)
    return make_mesh(model_parallel=args.model_parallel)


def train(args: argparse.Namespace, mesh=None):
    """The CLI's run on parsed flags ``args``, on ``mesh`` (None: one
    device): ``(result, state, metrics)``, the printed keys, the trained
    state and each step's metrics."""
    import dataclasses

    import torch

    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.core.partitioning import describe_shardings, shard_state
    from avsl_tpu_torch.decode.ctc import ctc_best_path_scores
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import avhubert_seq2seq_loss_fn

    if args.smoke:
        cfg = AVHuBERTConfig.tiny_test(dtype="float32", modality_dropout=0.2, audio_dropout=0.5)
        args.steps = 6
    elif args.config:
        cfg = AVHuBERTConfig.from_yaml(args.config)
    else:
        cfg = AVHuBERTConfig()
    cfg = dataclasses.replace(cfg, n_experts=args.n_experts, moe_top_k=args.moe_top_k)
    device = resolve_device(args.device) if mesh is None else mesh.device

    rows = make_synthetic_av_batchset(
        4 * args.batch_size, image=cfg.image_crop_size if not args.smoke else 24,
        vocab=cfg.vocab_size,
    )
    probe = next(batches(rows, args.batch_size, cfg.pad_token_id))
    model = build_avhubert(cfg, args.head, device=device, seed=0)
    if args.head == "seq2seq":
        loss_fn = avhubert_seq2seq_loss_fn(model, train=True)

        def host(batch):
            return batch
    else:
        loss_fn = cli_ctc_loss_fn(model, train=True)

        def host(batch):
            return ctc_batch(batch, cfg.pad_token_id)

    step = make_train_step(loss_fn, mesh=mesh)
    state = TrainState.create(model, make_optimizer(model, args.lr, args.steps), seed=0)
    n_sharded = 0
    if mesh is not None:
        n_sharded = len(describe_shardings(model, mesh))
        shard_state(state, mesh)
    it, epoch, losses, history = batches(rows, args.batch_size, cfg.pad_token_id), 0, [], []
    for _ in range(args.steps):
        try:
            batch = next(it)
        except StopIteration:
            epoch += 1
            it = batches(rows, args.batch_size, cfg.pad_token_id, epoch)
            batch = next(it)
        state, metrics = step(state, host(batch))
        history.append(metrics)
        losses.append(float(metrics["loss"]))

    # every rank evaluates the whole probe batch: one device's result
    eval_batch = batch_to_device(host(probe), device)
    result: Dict[str, Any] = {"head": args.head, "steps": args.steps, "first_loss": losses[0],
                              "last_loss": losses[-1]}
    if mesh is not None:
        result["mesh"] = dict(mesh.shape)
        result["sharded_params"] = n_sharded
    if args.n_experts > 0:
        result["n_experts"] = args.n_experts
    with torch.no_grad():
        if args.head == "seq2seq":
            loss, _ = avhubert_seq2seq_loss_fn(model, train=False)(eval_batch, None)
            result["eval_loss"] = float(loss)
        else:
            # one forward serves the loss and the best-path decode, as in JAX
            model.eval()
            logits = model(audio=eval_batch["audio"], video=eval_batch["video"],
                           padding_mask=eval_batch["padding_mask"])
            from avsl_tpu_torch.models.avhubert import ctc_loss

            result["eval_loss"] = float(ctc_loss(logits, eval_batch["logit_padding"],
                                                 eval_batch["labels"], eval_batch["label_padding"],
                                                 cfg.pad_token_id))
            seqs, scores = ctc_best_path_scores(
                logits.cpu().numpy(), blank_id=cfg.pad_token_id,
                logit_pad=1.0 - probe["padding_mask"].astype(np.float32))
            result["ctc_decoded_lens"] = [len(s) for s in seqs]
            result["ctc_mean_logprob"] = float(np.mean(scores))
    return result, state, history


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from avsl_tpu_torch.core.mesh import rank

    args = parse_args(argv)
    result = train(args, cli_mesh(args))[0]
    if rank() == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
