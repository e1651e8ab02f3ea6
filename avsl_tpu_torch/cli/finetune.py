"""Whisper-Flamingo fine-tuning entry point of the port.

Usage: ``python -m avsl_tpu_torch.cli.finetune [config.yaml] [--smoke]
[--device cuda|cpu]``

Port of ``avsl_tpu/cli/finetune.py``: the YAML keys of the reference's
training config (``configs/ami_whisper_flamingo_large.yaml``), ``<laugh>``
added and the vocab sized to the tokenizer, Whisper large-v2 with the
AV-HuBERT video tower (``add_gated_x_attn: 1``) trained under the regime
``select_optimizer`` picks (Flamingo: the gated ``x_attn``/``x_mlp``
sublayers, their gates and ``video_projection``; everything else frozen),
``flamingo_loss_fn`` with the YAML's SpecAugment, AV-mode mixing and
``freeze_video_batch_norm_stats``, the frozen-tower hoist under the JAX
CLI's own gate (:func:`hoist_enabled`), labels pinned to
``text_max_length``, teacher-forced WER validation, best checkpoint and
``pt_ckpt`` triage through ``partial_load``. Weights are fp32 and the
compute bf16 (fp32 with ``--smoke``). The YAML's
``enable_gradient_checkpointing`` rematerialises the Whisper encoder's
and the video tower's blocks (``models/layers.py::remat_block``);
``lora_rank > 0`` trains low-rank adapters (``lora_alpha``,
``lora_targets``, ``models/lora.py``) over the frozen model instead of the
regime's tensors, with an adapter-sized state and checkpoints and no
hoist, and composes with accumulation across batches; ``ema_decay > 0``
validates and pins ``best/`` with an EMA of the trained tensors
(``train/runner.py``).

Without ``--smoke`` it trains on the datasets that :func:`load_datasets`
finds on disk (``save_to_disk`` directories), as the JAX CLI does on real
data: batches by a token budget of ``(audio_max_length // 160) ×
batch_size`` 100 Hz frames (``data/batching.py``), so they vary in size;
accumulation across successive batches through :class:`MultiSteps` with
a runner accumulation of 1, so ``num_train_steps × accumulation``
micro-batches and no frozen-tower hoist; ``prefetch_batches > 0`` uploads
the next batch while a step runs; ``test_best`` on the test split when
there is one. ``--smoke`` trains the tiny test model on a synthetic
dataset with the JAX CLI's settings (6 steps, batch 4 × accumulation
min(YAML, 2) in one ``[accum, micro]`` batch, validation every 3 steps).
Runs on ``cuda`` unless ``--device cpu``. :func:`make_job` composes a
run from rows already loaded and :func:`run` trains it; ``main`` loads
the rows and calls both.

On a mesh: ``python -m torch.distributed.run --nproc_per_node N -m
avsl_tpu_torch.cli.finetune cfg.yaml`` with ``num_devices: N`` (or 0)
starts one rank per device (``cuda:LOCAL_RANK`` over NCCL; gloo on the
CPU with ``--device cpu``) and trains over a (data, model) mesh of
``model_parallel`` contiguous ranks per model group, with ``zero1`` or
``fsdp`` (``core/mesh.py``, ``core/partitioning.py``), as the JAX CLI
builds its mesh (``finetune.py:253-257,320-351`` there). Each rank reads
the same global batches and takes its rows; rank 0 alone writes
checkpoints, metrics and the summary lines. A world of one rank builds no
mesh, as JAX builds none on one device. Unlike JAX, which takes
``min(num_devices, devices)``, a nonzero ``num_devices`` other than the
world size raises: each rank is a process the launcher started.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from avsl_tpu_torch.core.mesh import rank
from avsl_tpu_torch.train.optim import TRAIN


def load_datasets(cfg):
    """``(train, val, test)`` datasets from disk (``datasets.load_from_disk``;
    None for a split not found), with the reference's fallback chain: the
    explicit split paths, else the siblings ``train``/``val``/``test`` of
    the train path's directory; then ``dataset_fraction`` (0 < f < 1 keeps
    the first fraction of each split) and the ``duration`` filter at
    ``max_duration_filter_seconds``. Port of
    ``avsl_tpu/cli/finetune.py::load_datasets``."""
    import datasets

    def load_one(path):
        if path and os.path.isdir(path):
            return datasets.load_from_disk(path)
        return None

    train = load_one(cfg.train_data_path)
    val = load_one(cfg.val_data_path)
    test = load_one(cfg.test_data_path)
    if train is None and cfg.train_data_path:
        root = os.path.dirname(cfg.train_data_path.rstrip("/"))
        train = load_one(os.path.join(root, "train"))
        val = val if val is not None else load_one(os.path.join(root, "val"))
        test = test if test is not None else load_one(os.path.join(root, "test"))
    frac = float(getattr(cfg, "dataset_fraction", 0) or 0)
    if 0 < frac < 1:
        def take(ds):
            return ds.select(range(int(len(ds) * frac))) if ds is not None else ds

        train, val, test = take(train), take(val), take(test)
    max_dur = float(getattr(cfg, "max_duration_filter_seconds", 0) or 0)
    if max_dur > 0:
        def filt(ds):
            if ds is None or "duration" not in ds.column_names:
                return ds
            return ds.filter(lambda d: float(d) <= max_dur, input_columns="duration")

        train, val, test = filt(train), filt(val), filt(test)
    return train, val, test


def make_synthetic_dataset(n: int = 8, seconds: float = 1.0) -> List[Dict[str, Any]]:
    """Miniature in-memory dataset for --smoke (no AMI data needed)."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        sr = 16000
        audio = (0.1 * rng.standard_normal(int(seconds * sr))).astype(np.float32)
        rows.append(
            {
                "audio": {"array": audio, "sampling_rate": sr},
                "transcript": f"synthetic utterance number {i}",
                "duration": seconds,
                "lip_video": None,
            }
        )
    return rows


def hoist_enabled(labels: Dict[str, str], cfg, lora_rank: int = 0, accum: int = 1) -> bool:
    """Whether the frozen towers are hoisted out of the accumulation loop,
    decided as the JAX CLI decides it (``finetune.py:279-302``): no LoRA,
    accumulation above 1, every parameter of the Whisper encoder and the
    video model labelled frozen (and at least one of them present),
    ``freeze_video_batch_norm_stats`` and ``hoist_frozen_towers`` (default
    on). The tower's LayerDrop is not consulted, as in JAX: above 0 it
    draws once a step for all the micro-steps."""
    if lora_rank != 0 or accum <= 1:
        return False
    tower = [v for k, v in labels.items() if k.split(".")[0] in ("encoder", "video_model")]
    towers_frozen = bool(tower) and all(v != TRAIN for v in tower)
    bn_frozen = bool(getattr(cfg, "freeze_video_batch_norm_stats", False))
    return towers_frozen and bn_frozen and bool(getattr(cfg, "hoist_frozen_towers", True))


def make_mesh_for(cfg):
    """The (data, model) mesh of ``num_devices`` ranks with
    ``model_parallel`` ranks on the model axis over the launched process
    group, or None in a world of one rank. Raises when ``num_devices`` > 1
    is asked for without ``torch.distributed.run``, or when a nonzero
    ``num_devices`` is not the world size."""
    from avsl_tpu_torch.core.mesh import make_mesh, world_size

    world = world_size()
    n = int(getattr(cfg, "num_devices", 0) or 0)
    if world == 1:
        if n > 1:
            raise RuntimeError(
                f"num_devices={n} needs one process per device: launch with python -m "
                f"torch.distributed.run --nproc_per_node {n} -m avsl_tpu_torch.cli.finetune ...")
        return None
    if n and n != world:
        raise ValueError(f"num_devices={n} but torch.distributed.run started {world} ranks; "
                         f"set num_devices to {world} (or 0)")
    return make_mesh(world, model_parallel=int(getattr(cfg, "model_parallel", 1) or 1))


def build_model(cfg, tokenizer, device, smoke: bool = False,
                vocab_size: Optional[int] = None, seed: int = 0):
    """The config's Whisper(-Flamingo) on ``device``, fp32 weights, with
    ``<laugh>`` added to ``tokenizer`` and the vocab sized to it (or to
    ``vocab_size`` when that is larger, e.g. a preset's full vocab over
    the offline byte tokenizer). Compute is fp32 under ``--smoke`` or a
    precision other than 16/bf16, else bf16. Returns ``(model, w_cfg)``."""
    from avsl_tpu_torch.models.factory import build_whisper_flamingo

    vocab = tokenizer.add_tokens(["<laugh>"])
    if vocab_size is not None:
        if vocab_size < vocab:
            raise ValueError(f"vocab_size {vocab_size} < the tokenizer's {vocab}")
        vocab = vocab_size
    bf16 = cfg.precision in (16, "16", "bf16")
    return build_whisper_flamingo(
        cfg.model_name, vocab_size=vocab, add_gated_x_attn=cfg.add_gated_x_attn,
        use_av_hubert_encoder=cfg.use_av_hubert_encoder, dropout_rate=cfg.dropout_rate,
        dtype="float32" if smoke or not bf16 else "bfloat16", param_dtype="float32",
        device=device, seed=seed,
        remat=bool(getattr(cfg, "enable_gradient_checkpointing", False)),
    )


def make_dataset(rows, tokenizer, cfg, w_cfg, train: bool):
    """``AmiVideoDataset`` over ``rows``, with lip video for a gated model."""
    from avsl_tpu_torch.data.runtime import AmiVideoDataset

    return AmiVideoDataset(rows, tokenizer, audio_max_length=int(cfg.audio_max_length),
                           n_mels=w_cfg.n_mels, lang=cfg.lang,
                           load_video=bool(cfg.add_gated_x_attn), train=train)


def make_collator(tokenizer, cfg, w_cfg):
    """The collator with the labels pinned to ``min(text_max_length,
    n_text_ctx)``, as the JAX CLI pins them."""
    from avsl_tpu_torch.data.runtime import WhisperVideoCollator

    label_len = min(int(getattr(cfg, "text_max_length", 350)), w_cfg.n_text_ctx)
    return WhisperVideoCollator(eot_id=tokenizer.eot, label_pad_len=label_len,
                                max_label_len=label_len)


def make_lora(cfg, model, seed: int = 0):
    """The config's adapters over ``model`` (``lora_rank``, ``lora_alpha``
    (16 when unset) and ``lora_targets`` (the attention query and value
    projections when unset)), drawn from a generator seeded ``seed + 1``
    (JAX draws them from ``PRNGKey(1)``), as a
    :class:`~avsl_tpu_torch.models.lora.LoraModel`; prints JAX's summary
    line."""
    from avsl_tpu_torch.models import lora as lora_mod

    rank = int(cfg.lora_rank)
    alpha = float(getattr(cfg, "lora_alpha", 16.0) or 16.0)
    targets = (tuple(cfg.lora_targets) if getattr(cfg, "lora_targets", None)
               else lora_mod.DEFAULT_TARGETS)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 1)
    adapters = lora_mod.init_lora(gen, model, rank, targets)
    s = lora_mod.lora_summary(model, adapters)
    print(f"lora: rank={rank} alpha={alpha} adapters={s['n_adapters']} "
          f"trainable={s['lora_params']:,} ({100 * s['trainable_fraction']:.3f}% of base)")
    return lora_mod.LoraModel(model, adapters, alpha, rank)


def make_runner(cfg, model, tokenizer, log_dir: str, ckpt_dir: str, seed: int = 0,
                cross_batch: bool = False, mesh=None):
    """``TrainerRunner`` over the regime ``select_optimizer`` picks (or,
    with ``lora_rank > 0``, the adapters of :func:`make_lora` under
    ``lora_optimizer``, the state's model then the ``LoraModel``),
    ``flamingo_loss_fn`` with the config's SpecAugment, AV-mode mixing and
    BatchNorm freeze, and the frozen-tower hoist when
    :func:`hoist_enabled`; the runner's ``hoisted`` says which. With
    ``cross_batch`` (bucketed batches, whose sizes vary) an accumulation
    above 1 goes through :class:`MultiSteps` and the runner steps every
    batch (accumulation 1), which keeps the hoist off; else each batch is
    reshaped to ``[accum, micro]``. On ``mesh`` the runner puts the state
    there with the config's ``zero1`` and ``fsdp`` (tensor parallelism on
    a model axis above 1, and there sequence parallelism in its step;
    under LoRA the base runs whole on every rank and ``fsdp`` splits the
    adapters' moments, ``core/partitioning.py::shard_state``)."""
    from avsl_tpu_torch.models.lora import lora_loss_fn
    from avsl_tpu_torch.train.loop import TrainState, batch_to_device
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn, flamingo_tower_precompute
    from avsl_tpu_torch.train.optim import MultiSteps, lora_optimizer, select_optimizer
    from avsl_tpu_torch.train.runner import TrainerRunner

    lora_rank = int(getattr(cfg, "lora_rank", 0) or 0)
    fsdp = bool(getattr(cfg, "fsdp", False))
    state_model = make_lora(cfg, model, seed) if lora_rank > 0 else model
    if lora_rank > 0:
        tx, labels = lora_optimizer(state_model, cfg, int(cfg.num_train_steps))
    else:
        tx, labels = select_optimizer(model, cfg, int(cfg.num_train_steps))
    accum = max(int(cfg.gradient_accumulation_steps), 1)
    runner_accum = accum
    if cross_batch and accum > 1:
        tx, runner_accum = MultiSteps(tx, accum), 1
    mixing = dict(spec_augment=getattr(cfg, "spec_augment", None),
                  prob_av=float(cfg.prob_use_av), prob_a=float(cfg.prob_use_a))
    loss_fn = flamingo_loss_fn(
        model, train=True,
        freeze_video_bn_stats=bool(getattr(cfg, "freeze_video_batch_norm_stats", False)),
        **mixing)
    if lora_rank > 0:
        loss_fn = lora_loss_fn(loss_fn, state_model)
    precompute = None
    if hoist_enabled(labels, cfg, lora_rank, runner_accum):
        precompute = flamingo_tower_precompute(model, train=True, freeze_video_bn_stats=True,
                                               **mixing)

    @torch.no_grad()
    def eval_logits(state, batch):
        state.model.eval()
        b = batch_to_device(batch, state.model.device)
        return state.model(b["input_ids"], b["dec_input_ids"], video=b.get("video"))

    runner = TrainerRunner(
        loss_fn, eval_logits, tx, TrainState.create(state_model, tx, seed=seed), tokenizer, cfg,
        log_dir=log_dir, ckpt_dir=ckpt_dir, grad_accum_steps=runner_accum, param_labels=labels,
        precompute_fn=precompute, mesh=mesh,
        partitioned_state=mesh is not None and mesh.shape.get("model", 1) > 1,
        zero1=bool(getattr(cfg, "zero1", False)), fsdp=fsdp,
    )
    runner.hoisted = precompute is not None
    return runner


@dataclass
class FinetuneJob:
    """A composed run: the model (under LoRA the frozen base, whose
    ``LoraModel`` is ``runner.state.model``), its runner, the datasets
    (``test_ds`` None without a test split) and ``batches(ds, batch_size,
    shuffle, epoch)``, bucketed unless ``smoke``."""

    cfg: Any
    device: torch.device
    model: Any
    runner: Any
    train_ds: Any
    val_ds: Any
    test_ds: Any
    batches: Callable[..., Iterator[Dict[str, np.ndarray]]]
    mesh: Any = None


def make_job(cfg, train_rows, val_rows, test_rows, device, smoke: bool = False,
             vocab_size: Optional[int] = None, seed: int = 0) -> FinetuneJob:
    """Compose a run from rows already loaded (datasets on disk, or lists
    of row dicts): the model (``pt_ckpt`` loaded when the file exists), the
    datasets, the collator and the runner. Without ``smoke`` batches are
    bucketed by the token budget and accumulation crosses batches. The
    mesh comes from :func:`make_mesh_for`."""
    from avsl_tpu_torch.cli.whisper_ft import batches as fixed_batches
    from avsl_tpu_torch.data.runtime import make_bucketed_loader
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.models.convert import load_torch_checkpoint_into

    mesh = make_mesh_for(cfg)
    tokenizer = get_tokenizer(getattr(cfg, "download_root", None), cfg.lang)
    model, w_cfg = build_model(cfg, tokenizer, device, smoke=smoke, vocab_size=vocab_size,
                               seed=seed)
    if getattr(cfg, "pt_ckpt", "") and os.path.exists(cfg.pt_ckpt):
        report = load_torch_checkpoint_into(model, cfg.pt_ckpt)
        print(f"pt_ckpt: loaded {len(report['loaded'])} tensors, "
              f"missing {len(report['missing'])}, unexpected {len(report['unexpected'])}")
    collator = make_collator(tokenizer, cfg, w_cfg)

    def batches(ds, batch_size: int, shuffle: bool, epoch: int = 0):
        if smoke:
            return fixed_batches(ds, collator, batch_size, shuffle, epoch)
        # the token budget: audio_max_length x batch_size, in 100 Hz frames
        batch_bins = (int(cfg.audio_max_length) // 160) * max(batch_size, 1)
        return make_bucketed_loader(ds, collator, batch_bins=batch_bins, shuffle=shuffle,
                                    epoch=epoch)

    def dataset(rows, train):
        return None if rows is None else make_dataset(rows, tokenizer, cfg, w_cfg, train=train)

    runner = make_runner(cfg, model, tokenizer,
                         log_dir=os.path.join(cfg.log_output_dir, cfg.train_id),
                         ckpt_dir=os.path.join(cfg.check_output_dir, cfg.train_id), seed=seed,
                         cross_batch=not smoke, mesh=mesh)
    return FinetuneJob(cfg, torch.device(device), model, runner, dataset(train_rows, True),
                       dataset(val_rows, False), dataset(test_rows, False), batches, mesh)


def train_batches(job: FinetuneJob, epoch: int) -> Iterator[Dict[str, Any]]:
    """Epoch ``epoch``'s train batches of ``batch_size ×`` the runner's
    accumulation items (bucketed unless smoke); with ``prefetch_batches >
    0`` they are uploaded to the job's device ahead of the step that takes
    them (``data/prefetch.py``): on a mesh, each rank's rows when the
    runner steps every batch, the whole batch when it reshapes batches to
    ``[accum, micro]`` (its micro-batches are the global batch's)."""
    from avsl_tpu_torch.data.prefetch import prefetch_to_device

    cfg = job.cfg
    it = job.batches(job.train_ds, int(cfg.batch_size) * job.runner.accum, True, epoch)
    n_prefetch = int(getattr(cfg, "prefetch_batches", 0) or 0)
    if n_prefetch <= 0:
        return it
    mesh = job.mesh if job.runner.accum == 1 else None
    return prefetch_to_device(it, job.device, size=n_prefetch, mesh=mesh)


def run(job: FinetuneJob) -> Dict[str, Any]:
    """Train ``job`` for ``num_train_steps`` optimizer steps (``× accum``
    micro-batches when the runner steps every batch) over
    :func:`train_batches`, validating every ``validate_every_n_batches``
    of them; then ``test_best`` on the test split when there is one."""
    cfg, runner = job.cfg, job.runner
    accum = max(int(cfg.gradient_accumulation_steps), 1)
    eval_bs = int(cfg.eval_batch_size)
    result = runner.fit(
        train_batches=lambda epoch: train_batches(job, epoch),
        val_batches=None if job.val_ds is None else (
            lambda: job.batches(job.val_ds, eval_bs, False)),
        # num_train_steps counts optimizer steps; under MultiSteps each
        # takes `accum` micro-batches
        num_steps=int(cfg.num_train_steps) * accum // runner.accum,
        validate_every=int(cfg.validate_every_n_batches),
        sanity_val_steps=int(getattr(cfg, "num_sanity_val_steps", 0)),
    )
    result["hoisted"] = runner.hoisted
    lead = rank() == 0
    if lead:
        print(f"done: step={result['final_step']} best_wer={result['best_wer']:.4f} "
              f"(step {result['best_step']})")
    if job.test_ds is not None:
        tm = runner.test_best(lambda: job.batches(job.test_ds, eval_bs, False))
        if lead:
            print(f"test (best ckpt step {result['best_step']}): "
                  f"wer={tm.get('test/wer_av'):.4f} cer={tm.get('test/cer_av'):.4f}")
        result["test"] = tm
    return result


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    import torch.distributed as dist

    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.device import resolve_device
    from avsl_tpu_torch.core.mesh import init_distributed

    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    joined = dist.is_initialized()
    device = init_distributed(resolve_device(args.device))
    joined = dist.is_initialized() and not joined
    cfg = FlamingoTrainConfig.from_yaml(args.config) if args.config else FlamingoTrainConfig()
    if args.smoke:
        cfg.model_name = "test"
        cfg.num_train_steps = 6
        cfg.validate_every_n_batches = 3
        # a YAML's accumulation (capped at 2) goes through, so the
        # accumulation and the hoist can be driven under --smoke
        cfg.gradient_accumulation_steps = min(
            int(getattr(cfg, "gradient_accumulation_steps", 1) or 1), 2)
        cfg.batch_size = 4
        cfg.audio_max_length = 16000
        cfg.warmup_steps = 1
        rows = make_synthetic_dataset(8), make_synthetic_dataset(4), None
    else:
        rows = load_datasets(cfg)
        if rows[0] is None:
            raise FileNotFoundError(f"train dataset not found at {cfg.train_data_path!r}")
    try:
        return run(make_job(cfg, *rows, device, smoke=args.smoke))
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
