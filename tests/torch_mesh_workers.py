"""Ranks for the mesh tests of the port: spawned processes over a gloo
process group with a ``file://`` rendezvous (no TCP port, so parallel
test workers never collide), one torch thread each, and no ``jax``
import (this module and what it imports are the port's alone).

``spawn(fn, world, tmp_path, *args)`` runs ``fn(rank, world, *args)`` in
``world`` ranks and returns their results in rank order; a rank that
raises fails the parent with its traceback. The tiny Whisper-Flamingo
model of the parity tests is rebuilt in each rank from a state dict the
parent wrote (``load_flamingo``)."""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback

import numpy as np
import torch

TIMEOUT_S = 300


def _run(fn, rank, world, init_file, q, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            q.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 (relayed to the parent)
        q.put((rank, "error", traceback.format_exc()))


def spawn(fn, world: int, tmp_path, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; their
    results in rank order."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init_file = os.path.join(str(tmp_path), f"rendezvous_{fn.__name__}_{world}")
    procs = [ctx.Process(target=_run, args=(fn, r, world, init_file, q, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, value = q.get(timeout=TIMEOUT_S)
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    except queue.Empty:
        raise AssertionError(f"ranks timed out after {TIMEOUT_S} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the tiny Whisper-Flamingo in a rank
# ---------------------------------------------------------------------------

ZERO_RATES = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  dropout_input=0.0, layerdrop=0.0, modality_dropout=0.0)
TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=20, weight_decay=0.01,
                 add_gated_x_attn=1, prob_use_av=1.0, prob_use_a=0.5)
MIXING = dict(prob_av=1.0, prob_a=0.5)


def load_flamingo(state_path: str, vocab_size=None):
    """The port's tiny fp32 Whisper-Flamingo (every tower rate 0) on the
    CPU with the state dict at ``state_path``."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_whisper_flamingo

    port, _ = build_whisper_flamingo(
        "test", add_gated_x_attn=1, use_av_hubert_encoder=True,
        av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32", **ZERO_RATES),
        dtype="float32", param_dtype="float32", device="cpu", vocab_size=vocab_size)
    port.load_state_dict(torch.load(state_path, weights_only=True))
    return port


def train_flamingo(state_path, batches, mesh_kw, accum=2, vocab_size=None, steps_out=None):
    """Train the carried tiny Flamingo (Flamingo regime) on ``batches``
    (global batches) with ``make_train_step`` on a mesh built from
    ``mesh_kw`` (``n``, ``mp``, ``zero1``, ``fsdp``; None: no mesh).
    Returns per-step losses and grad norms, the trained tensors whole, the
    BatchNorm statistics, and the per-rank bytes of parameters plus Adam
    moments."""
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.core.partitioning import local_tensor, shard_state
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step
    from avsl_tpu_torch.train import select_optimizer
    from avsl_tpu_torch.train.optim import TRAIN

    port = load_flamingo(state_path, vocab_size)
    opt, labels = select_optimizer(port, FlamingoTrainConfig(**TRAIN_CFG), 20)
    state = TrainState.create(port, opt)
    mesh = None
    if mesh_kw is not None:
        mesh = make_mesh(mesh_kw["n"], model_parallel=mesh_kw.get("mp", 1))
        shard_state(state, mesh, zero1=mesh_kw.get("zero1", False),
                    fsdp=mesh_kw.get("fsdp", False))
    step = make_train_step(flamingo_loss_fn(port, train=True, **MIXING), mesh=mesh,
                           grad_accum_steps=accum, param_labels=labels)
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    named = dict(port.named_parameters())
    if state.layout is None:
        whole = {n: p.detach().clone() for n, p in named.items()}
    else:
        whole = {n: state.layout.full(n, p) for n, p in named.items()}
    trained = {n: whole[n].numpy() for n in named if labels[n] == TRAIN}
    frozen = {n: whole[n].numpy() for n in named if labels[n] != TRAIN}
    stats = {n: b.detach().numpy().copy() for n, b in port.named_buffers() if "running_" in n}
    inner = getattr(opt, "inner", opt)
    nbytes = sum(local_tensor(p).numel() * 4 for p in named.values())
    nbytes += sum(t.numel() * 4 for t in inner.mu + inner.nu)
    return {"loss": losses, "grad_norm": norms, "trained": trained, "frozen": frozen,
            "stats": stats, "bytes": nbytes}


def eval_flamingo(path, batch, mesh=None) -> float:
    """``make_eval_step``'s loss on the first micro-batch of ``batch``."""
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_eval_step

    port = load_flamingo(path)
    step = make_eval_step(flamingo_loss_fn(port, train=False), mesh=mesh)
    return float(step(TrainState.create(port, None), {k: v[0] for k, v in batch.items()})["loss"])


def dp_ranks(rank, world, path, batches, three_row):
    """Every data-parallel variant in the same 2 ranks."""
    import avsl_tpu_torch.core.partitioning as part
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.train import TrainerRunner, TrainState, flamingo_loss_fn
    from avsl_tpu_torch.train import select_optimizer
    from avsl_tpu_torch.core.config import FlamingoTrainConfig

    part.ZERO1_MIN_ELEMS = 1024  # so the tiny model's moments split, as JAX's test patches it
    out = {name: train_flamingo(path, batches, dict(n=2, **kw))
           for name, kw in (("dp", {}), ("zero1", {"zero1": True}), ("fsdp", {"fsdp": True}))}
    # a 3-row batch on 2 data ranks: every rank takes it whole
    out["three"] = train_flamingo(path, [three_row], dict(n=2), accum=1)
    out["eval"] = eval_flamingo(path, batches[0], make_mesh(2))

    # the runner end to end (test_fsdp.py's runner case): fsdp against replicated
    class _Cfg:
        gradient_accumulation_steps = 2
        num_train_steps = 2

    runs = {}
    for fsdp in (False, True):
        port = load_flamingo(path)
        opt, labels = select_optimizer(port, FlamingoTrainConfig(**TRAIN_CFG), 20)
        runner = TrainerRunner(flamingo_loss_fn(port, train=True, **MIXING), None, None,
                               TrainState.create(port, opt), None, _Cfg(), mesh=make_mesh(2),
                               log_dir=os.path.join(os.path.dirname(path), f"log{rank}{fsdp}"),
                               ckpt_dir=os.path.join(os.path.dirname(path), f"ck{fsdp}"),
                               fsdp=fsdp, param_labels=labels)
        losses = []
        for batch in batches[:2]:
            runner.state, m = runner.train_step(runner.state, batch)
            losses.append(float(m["loss"]))
        runs[fsdp] = (losses, runner.fsdp, runner.partitioned,
                      type(next(port.parameters())).__name__)
    out["runner"] = runs
    return out


def np_batches(batches):
    """numpy copies of a list of batches (the parent's JAX inputs)."""
    return [{k: np.asarray(v) for k, v in b.items()} for b in batches]


def tp_ranks(rank, world, path, path_odd, batches):
    """dp 1 x mp 2 on 2 ranks: the vocab-sharded embedding (256 ids) and
    a replicated one (257 ids), with what each rank holds of them."""
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.core.partitioning import describe_shardings

    out = {"even": train_flamingo(path, batches, dict(n=2, mp=2)),
           "odd": train_flamingo(path_odd, batches, dict(n=2, mp=2), vocab_size=257)}
    mesh = make_mesh(2, model_parallel=2)
    out["sharded"] = {v: sorted(n for n, _, _ in describe_shardings(load_flamingo(p, v), mesh))
                      for v, p in ((256, path), (257, path_odd))}
    return out


def tp_fsdp_ranks(rank, world, path, batches):
    """dp 2 x mp 2 with FSDP over the data axis, on 4 ranks."""
    return train_flamingo(path, batches, dict(n=4, mp=2, fsdp=True))


def _flamingo_state(path):
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.train import TrainState, select_optimizer

    port = load_flamingo(path)
    opt, labels = select_optimizer(port, FlamingoTrainConfig(**TRAIN_CFG), 20)
    return TrainState.create(port, opt), labels


def restore_ranks(rank, world, path, ckpt, out_dir, batch, layouts):
    """At dp ``world`` under FSDP (``layouts`` None), one step on ``batch``
    then ``save_checkpoint(ckpt, step 1)``; else, for each ``(name, mp,
    zero1, fsdp)`` of ``layouts``, ``restore_sharded`` the checkpoint into
    a fresh state on that mesh (``mp`` 0: no mesh) and save it again to
    ``out_dir/name``. Returns the local shapes of a few parameters."""
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.train import flamingo_loss_fn, make_train_step
    from avsl_tpu_torch.train.checkpoints import restore_sharded, save_checkpoint

    if layouts is None:
        state, labels = _flamingo_state(path)
        mesh = make_mesh(world)
        step = make_train_step(flamingo_loss_fn(state.model, train=True, **MIXING), mesh=mesh,
                               grad_accum_steps=2, param_labels=labels, fsdp=True)
        for _ in range(2):  # the first update has learning rate 0
            state, _ = step(state, batch)
        save_checkpoint(ckpt, state, 1)
        return {}
    shapes = {}
    for name, mp, zero1, fsdp in layouts:
        state, _ = _flamingo_state(path)
        mesh = make_mesh(world, model_parallel=mp) if mp else None
        restore_sharded(ckpt, state, mesh, zero1=zero1, fsdp=fsdp)
        save_checkpoint(os.path.join(out_dir, name), state, 1)
        named = dict(state.model.named_parameters())
        shapes[name] = {k: tuple(named[k].shape) if not fsdp else
                        tuple(named[k].to_local().shape) for k in
                        ("decoder.blocks.0.x_attn.query.weight",
                         "decoder.blocks.0.x_attn.out.weight",
                         "decoder.token_embedding.weight")}
        shapes[name]["mu"] = tuple(state.optimizer.mu[0].shape)
    return shapes
