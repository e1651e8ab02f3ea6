"""AV-HuBERT pretraining entry point of the port (masked-cluster prediction).

Usage::

    python -m avsl_tpu_torch.cli.pretrain --smoke [--device cpu]
    python -m avsl_tpu_torch.cli.pretrain --config avhubert_large.yaml \\
        --num_clusters 500 [--km_model km.npz] [--steps N] [--iterations 2]

Port of ``avsl_tpu/cli/pretrain.py``, with its flags and flow: corpus ->
k-means targets -> a pretrained encoder that the fine-tune heads load
(:func:`~avsl_tpu_torch.train.checkpoints.partial_load`). Without a corpus
it synthesises aligned audio features and lip frames whose frames follow
slowly switching latent states (:func:`make_synthetic_pretrain_rows`), and
takes its targets by k-means over the rows' audio features (15 Lloyd
iterations, seed 0; ``--km_model`` loads the npz codebook when the file
exists and writes the fresh fit there otherwise). The model is
:class:`~avsl_tpu_torch.models.pretrain.AVHuBERTForPretraining` with fp32
weights and the config's compute dtype, trained by
``avhubert_pretrain_loss_fn`` under the AV-HuBERT CLI's optimizer (global
norm clip 10, AdamW b1 0.9, b2 0.98, eps 1e-6, weight decay 0.01 over
``linear_warmup_decay(lr, steps // 10, steps)``). ``--iterations`` > 1
follows the HuBERT recipe: after each iteration, k-means over the
``--relabel_layer`` features (default the middle layer) gives new targets,
and a fresh model trains on them. ``--checkpoint_dir`` saves the last
state. It prints one JSON line with the JAX CLI's keys. ``--smoke`` runs
the tiny fp32 model (modality dropout 0.2, audio dropout 0.5, mask
probability 0.5 over spans of 4) for at most 6 steps on at most 8
clusters.

Runs on ``cuda`` unless ``--device cpu``. ``--experts_parallel`` or
``--model_parallel`` above 1 trains on the JAX CLI's mesh
(``cli/avhubert_ft.py::cli_mesh``), one process a rank under ``python -m
torch.distributed.run``: each iteration's fresh state is put on it, the
relabel tap gives every rank the features of the whole rows (so every
rank fits the same k-means targets), the result adds ``mesh`` and
``sharded_params``, and rank 0 prints it.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def make_synthetic_pretrain_rows(
    n: int, t: int = 24, feat_dim: int = 104, image: int = 24, seed: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """Aligned audio/video rows whose frames have 4 latent states, so
    cluster targets derived from the audio features are predictable from
    context (and from the video, which renders the same state as a bright
    quadrant). The JAX CLI's rows, draw for draw."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(4, feat_dim)).astype(np.float32) * 2.0
    rows = []
    for _ in range(n):
        state = np.repeat(rng.integers(0, 4, t // 4 + 1), 4)[:t]
        audio = protos[state] + 0.3 * rng.normal(size=(t, feat_dim)).astype(np.float32)
        video = np.zeros((t, image, image, 1), np.float32)
        for i, s in enumerate(state):
            qy, qx = divmod(int(s), 2)
            h = image // 2
            video[i, qy * h:(qy + 1) * h, qx * h:(qx + 1) * h, 0] = 1.0
        video += 0.1 * rng.normal(size=video.shape).astype(np.float32)
        rows.append({"audio_feats": audio, "video_feats": video})
    return rows


def collate_pretrain(rows, targets_per_row) -> Dict[str, np.ndarray]:
    """Pad rows to one batch: audio features, lip frames and targets to the
    longest row, with ``padding_mask`` (True = a real frame)."""
    b = len(rows)
    t = max(len(r["audio_feats"]) for r in rows)
    feat_dim = rows[0]["audio_feats"].shape[1]
    ih = rows[0]["video_feats"].shape[1]
    audio = np.zeros((b, t, feat_dim), np.float32)
    video = np.zeros((b, t, ih, ih, 1), np.float32)
    pad = np.zeros((b, t), bool)
    tgt = np.zeros((b, t), np.int32)
    for i, (r, tg) in enumerate(zip(rows, targets_per_row)):
        length = len(r["audio_feats"])
        audio[i, :length] = r["audio_feats"]
        video[i, :length] = r["video_feats"]
        pad[i, :length] = True
        tgt[i, :length] = tg[:length]
    return {"audio": audio, "video": video, "padding_mask": pad, "targets": tgt}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    import dataclasses

    import torch

    from avsl_tpu_torch.cli.avhubert_ft import cli_mesh, make_optimizer
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.core.mesh import rank
    from avsl_tpu_torch.core.partitioning import describe_shardings, shard_state
    from avsl_tpu_torch.data.clustering import KMeansQuantizer
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.models.pretrain import extract_layer_features
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import avhubert_pretrain_loss_fn

    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="fairseq-style model card YAML")
    p.add_argument("--num_clusters", type=int, default=100,
                   help="k-means codebook size (one target group)")
    p.add_argument("--km_model", default=None,
                   help="npz codebook to reuse / path to save a fresh fit")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--iterations", type=int, default=1,
                   help="HuBERT-style pretraining iterations: after each, "
                        "re-cluster on layer features and retrain fresh")
    p.add_argument("--relabel_layer", type=int, default=None,
                   help="1-indexed encoder layer tapped for iteration-2+ "
                        "clustering features (default: middle layer)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--n_experts", type=int, default=0)
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--experts_parallel", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    mesh = cli_mesh(args)
    if args.smoke:
        cfg = AVHuBERTConfig.tiny_test(dtype="float32", modality_dropout=0.2, audio_dropout=0.5,
                                       mask_prob_audio=0.5, mask_length_audio=4)
        args.steps = min(args.steps, 6)
        args.num_clusters = min(args.num_clusters, 8)
    elif args.config:
        cfg = AVHuBERTConfig.from_yaml(args.config)
    else:
        cfg = AVHuBERTConfig()
    if args.n_experts > 0:
        cfg = dataclasses.replace(cfg, n_experts=args.n_experts, moe_top_k=args.moe_top_k)
    device = resolve_device(args.device) if mesh is None else mesh.device

    rows = make_synthetic_pretrain_rows(4 * args.batch_size, feat_dim=cfg.audio_feat_dim,
                                        image=cfg.image_crop_size if not args.smoke else 24)

    # targets: k-means over the per-frame audio features
    quant = None
    if args.km_model and os.path.exists(args.km_model):
        quant = KMeansQuantizer.load(args.km_model, device=device)
    if quant is None:
        quant = KMeansQuantizer(device=device).fit(
            np.concatenate([r["audio_feats"] for r in rows]), k=args.num_clusters, n_iters=15,
            seed=0)
        if args.km_model:
            quant.save(args.km_model)
    targets = [quant(r["audio_feats"]) for r in rows]

    def batches(epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.random.default_rng(epoch).permutation(len(rows))
        for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
            sel = order[i:i + args.batch_size]
            yield collate_pretrain([rows[j] for j in sel], [targets[j] for j in sel])

    probe = next(batches())
    relabel_layer = args.relabel_layer or max(1, cfg.num_hidden_layers // 2)

    iterations: List[Dict[str, float]] = []
    for iteration in range(max(1, args.iterations)):
        # the HuBERT recipe: each iteration trains a fresh model on the
        # current targets (iteration 1: k-means of the input features; 2+:
        # k-means of the previous model's layer features)
        model = build_avhubert(cfg, "pretrain", device=device, seed=iteration,
                               num_classes=(quant.n_clusters,))
        state = TrainState.create(model, make_optimizer(model, args.lr, args.steps), seed=0)
        if mesh is not None:
            n_sharded = len(describe_shardings(model, mesh))
            shard_state(state, mesh)
        step = make_train_step(avhubert_pretrain_loss_fn(model, train=True), mesh=mesh)
        it, epoch, losses = batches(0), 0, []
        for _ in range(args.steps):
            try:
                batch = next(it)
            except StopIteration:
                epoch += 1
                it = batches(epoch)
                batch = next(it)
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))

        gen = torch.Generator(device=device)
        gen.manual_seed(42)
        with torch.no_grad():
            eval_loss, m = avhubert_pretrain_loss_fn(model, train=False)(
                batch_to_device(probe, device), gen)
        iterations.append({
            "first_loss": losses[0],
            "last_loss": losses[-1],
            "eval_loss": float(eval_loss),
            "eval_acc_masked": float(m["acc_m"]),
            "eval_acc_unmasked": float(m["acc_u"]),
        })

        if iteration + 1 < args.iterations:
            # re-cluster on the layer's features (iteration 2+ targets)
            feats_rows = []
            for i in range(0, len(rows), args.batch_size):
                chunk = rows[i:i + args.batch_size]
                b = batch_to_device(collate_pretrain(
                    chunk, [np.zeros(len(r["audio_feats"]), np.int32) for r in chunk]), device)
                feats = extract_layer_features(model, relabel_layer, audio=b["audio"],
                                               video=b["video"], padding_mask=b["padding_mask"])
                feats = feats.float().cpu().numpy()
                for j, r in enumerate(chunk):
                    feats_rows.append(feats[j, :len(r["audio_feats"])])
            quant = KMeansQuantizer(device=device).fit(
                np.concatenate(feats_rows), k=args.num_clusters, n_iters=15, seed=iteration)
            targets = [quant(f) for f in feats_rows]

    if args.checkpoint_dir:
        from avsl_tpu_torch.train.checkpoints import save_checkpoint

        save_checkpoint(args.checkpoint_dir, state, step=args.steps)

    result = {
        "steps": args.steps,
        "num_clusters": int(quant.n_clusters),
        "iterations": iterations,
        "relabel_layer": relabel_layer if args.iterations > 1 else None,
        **iterations[-1],
    }
    if mesh is not None:
        result["mesh"] = dict(mesh.shape)
        result["sharded_params"] = n_sharded
    if rank() == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
