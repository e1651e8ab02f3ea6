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

import contextlib
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
    ``mesh_kw`` (``n``, ``mp``, ``zero1``, ``fsdp``, and ``sp``, the step's
    ``sequence_parallel``; None: no mesh).
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
                           grad_accum_steps=accum, param_labels=labels,
                           sequence_parallel=(mesh_kw or {}).get("sp"))
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


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

DROPOUT_RATES = dict(hidden_dropout=0.1, attention_dropout=0.0, activation_dropout=0.1,
                     dropout_input=0.1, layerdrop=0.1, modality_dropout=0.0)


def load_flamingo_dropout(state_path: str):
    """The carried tiny Whisper-Flamingo with dropout on: Whisper 0.1 and
    the tower's hidden, activation and input dropout and LayerDrop."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_whisper_flamingo

    port, _ = build_whisper_flamingo(
        "test", add_gated_x_attn=1, use_av_hubert_encoder=True,
        av_hubert_cfg=AVHuBERTConfig.tiny_test(dtype="float32", **DROPOUT_RATES),
        dtype="float32", param_dtype="float32", device="cpu", dropout_rate=0.1)
    port.load_state_dict(torch.load(state_path, weights_only=True))
    return port


def _count_scatters():
    """Patch ``SequenceSplit.scatter`` to count its calls; returns the
    counter (a one-element list)."""
    from avsl_tpu_torch.core import mesh as mesh_mod

    n = [0]
    inner = mesh_mod.SequenceSplit.scatter

    def counted(self, x):
        n[0] += 1
        return inner(self, x)

    mesh_mod.SequenceSplit.scatter = counted
    return n


def sp_ranks(rank, world, path, mel, video, odd_video, batches, eval_batch):
    """Every sequence-parallel case on 2 model ranks (dp 1 x mp 2): the
    encoders under the scope (the video at an even and an odd frame
    count), train steps with SP auto, on and off with dropout on, the eval
    step, and the runner's scope on a model-parallel and a data-only
    mesh. At a world of 1: the same cases without a mesh."""
    from avsl_tpu_torch.core import mesh as mesh_mod
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.partitioning import shard_state
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_eval_step
    from avsl_tpu_torch.train import make_train_step, select_optimizer

    n_scatter = _count_scatters()
    mp_mesh = None if world == 1 else mesh_mod.make_mesh(world, model_parallel=world)
    out = {}

    # the encoders: features and projected video, even and odd T
    port = load_flamingo(path)
    if mp_mesh is not None:
        shard_state(TrainState.create(port, None), mp_mesh)
    with torch.no_grad(), mesh_mod.activation_sharding_scope(mp_mesh):
        for name, v in (("even", video), ("odd", odd_video)):
            before = n_scatter[0]
            feats, xv = port.encode(torch.as_tensor(mel), torch.as_tensor(v))
            out[f"encode_{name}"] = (feats.numpy(), xv.numpy(), n_scatter[0] - before)

    # train steps on the dropout model: SP auto (None), on and off
    def train(sp, record=None, batches=batches):
        model = load_flamingo_dropout(path)
        opt, labels = select_optimizer(model, FlamingoTrainConfig(**TRAIN_CFG), 20)
        state = TrainState.create(model, opt, seed=3)
        loss_fn = flamingo_loss_fn(model, train=True, spec_augment="ls-basic", **MIXING)

        def spy(batch, gen):
            if record is not None:
                record.append(mesh_mod._ACTIVATION_MESH[0] is not None)
            return loss_fn(batch, gen)

        step = make_train_step(spy, mesh=mp_mesh, grad_accum_steps=2, param_labels=labels,
                               sequence_parallel=sp)
        before, losses = n_scatter[0], []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        named = dict(model.named_parameters())
        whole = {n: (named[n].detach() if state.layout is None else
                     state.layout.full(n, named[n])).numpy().copy() for n in opt.names}
        return {"loss": losses, "trained": whole, "scatters": n_scatter[0] - before}

    seen = []
    out["auto"] = dict(train(None, seen), seen=seen)
    if mp_mesh is not None:
        out["on"] = train(True, batches=batches[:1])
        out["off"] = train(False)

    # the eval step (SP auto)
    model = load_flamingo(path)
    before = n_scatter[0]
    ev = make_eval_step(flamingo_loss_fn(model, train=False), mesh=mp_mesh)
    out["eval"] = (float(ev(TrainState.create(model, None), eval_batch)["loss"]),
                   n_scatter[0] - before)

    # the runner (tests/test_runner.py:165): in the scope on a
    # model-parallel mesh, not on a data-only one
    if mp_mesh is not None:
        from avsl_tpu_torch.train import TrainerRunner

        class _Cfg:
            gradient_accumulation_steps = 2
            num_train_steps = 2

        runs = {}
        for name, mesh in (("mp2", mp_mesh), ("dp2", mesh_mod.make_mesh(world))):
            model = load_flamingo(path)
            opt, labels = select_optimizer(model, FlamingoTrainConfig(**TRAIN_CFG), 20)
            loss_fn = flamingo_loss_fn(model, train=True, **MIXING)
            seen = []

            def spy(batch, gen, loss_fn=loss_fn, seen=seen):
                seen.append(mesh_mod._ACTIVATION_MESH[0] is not None)
                return loss_fn(batch, gen)

            runner = TrainerRunner(spy, None, None, TrainState.create(model, opt), None, _Cfg(),
                                   mesh=mesh, log_dir=os.path.join(os.path.dirname(path),
                                                                   f"splog{rank}{name}"),
                                   ckpt_dir=os.path.join(os.path.dirname(path), f"spck{name}"),
                                   param_labels=labels)
            runner.state, _ = runner.train_step(runner.state, batches[0])
            runs[name] = seen
        out["runner"] = runs
    return out


# ---------------------------------------------------------------------------
# the serving mesh
# ---------------------------------------------------------------------------


def load_serving(state_path: str, av: bool = True):
    """The tiny fp32 serving model (the ByteTokenizer's vocabulary with
    ``<laugh>``; with the tiny video tower when ``av``) from a state
    dict, in eval mode."""
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.models import build_whisper_flamingo

    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    port, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=int(av),
                                     use_av_hubert_encoder=av, dtype="float32", device="cpu")
    port.load_state_dict(torch.load(state_path, weights_only=True))
    return port.eval()


def _results(res):
    return [(r.id, r.text, list(r.tokens), r.avg_logprob, r.has_video, r.words) for r in res]


def serve_cases(path, draft_path, items, kw, variants, mesh_for=None, daemon=None):
    """Transcribe ``items`` with each ``(name, mp, options)`` of
    ``variants`` (``options["draft"]``: the draft of ``draft_path``),
    each on ``mesh_for(mp)`` (None: no mesh); with ``daemon`` (``(mp,
    lead)``) also through a :class:`TranscriptionServer` on that mesh,
    this rank leading when ``lead``, else following."""
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber, TranscriptionServer

    out = {}
    for name, mp, options in variants:
        options = dict(options)
        if options.pop("draft", False):
            options.update(draft_model=load_serving(draft_path, av=False), spec_k=3)
        tr = StreamingTranscriber(load_serving(path), ByteTokenizer(), **kw, **options,
                                  mesh=None if mesh_for is None else mesh_for(mp))
        out[name] = _results(tr.transcribe(items))
        if name == "options":
            out["fallback_calls"] = tr._fallback_calls
    if daemon is not None:
        mp, lead = daemon
        tr = StreamingTranscriber(load_serving(path), ByteTokenizer(), **kw, mesh=mesh_for(mp))
        if lead:
            server = TranscriptionServer(tr, port=0, max_wait_ms=200.0).start()
            pending = [server.submit(it) for it in items]
            for p in pending:
                p.done.wait(timeout=TIMEOUT_S)
            server.stop()
            out["daemon"] = [(p.result.id, p.result.text, list(p.result.tokens))
                             if p.error is None else p.error for p in pending]
        else:
            out["daemon_batches_followed"] = tr.follow()
    return out


def serve_ranks(rank, world, path, draft_path, items, kw, variants, daemon_mp):
    """:func:`serve_cases` on ``world`` gloo ranks, each variant on a mesh
    of ``world`` ranks with its model axis; rank 0 leads the daemon. At a
    world of 1: the variants without a mesh, and no daemon."""
    from avsl_tpu_torch.core.mesh import make_mesh

    if world == 1:
        return serve_cases(path, draft_path, items, kw, variants)
    return serve_cases(path, draft_path, items, kw, variants,
                       mesh_for=lambda mp: make_mesh(world, model_parallel=mp),
                       daemon=(daemon_mp, rank == 0))


def fsdp_dp1_ranks(rank, world, path, batches):
    """FSDP at a data axis of 1 (world 1) against no mesh: JAX's no-op, so
    the same numbers bit for bit and no FSDP2 parameter."""
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.core.partitioning import shard_state

    out = {"none": train_flamingo(path, batches, None),
           "fsdp": train_flamingo(path, batches, dict(n=1, fsdp=True))}
    state, _ = _flamingo_state(path)
    shard_state(state, make_mesh(1), fsdp=True)
    out["layout_fsdp"] = state.layout.fsdp
    out["param_types"] = sorted({type(p).__name__ for p in state.model.parameters()})
    return out


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def load_moe_block(state_path: str, cf: float):
    """The port's MoE ``TransformerBlock`` of ``tests/test_moe.py:233`` (d
    16, 2 heads, F 32, 4 experts of top 2, fp32) at capacity factor ``cf``
    with the state dict at ``state_path``."""
    from avsl_tpu_torch.models.layers import TransformerBlock

    block = TransformerBlock(16, 2, 32, dtype=torch.float32, param_dtype=torch.float32,
                             n_experts=4, moe_top_k=2, moe_capacity_factor=cf)
    block.load_state_dict(torch.load(state_path, weights_only=True))
    return block


def moe_block_step(block, x, mesh):
    """``sum(y^2) + 0.01 aux`` of the block on the global batch ``x`` and
    its gradients, whole, as the train step forms them on ``mesh`` (None:
    one process): each data rank runs its rows inside the row scope,
    backs ``dp x`` its part of the sum plus the balance term, and the
    gradients are averaged over the data group. Returns (loss, aux,
    gradients by name)."""
    import torch.distributed as dist

    from avsl_tpu_torch.core.mesh import RowShard, row_shard_scope
    from avsl_tpu_torch.core.partitioning import shard_state
    from avsl_tpu_torch.models.intermediates import collect_intermediates
    from avsl_tpu_torch.models.moe import moe_aux_loss
    from avsl_tpu_torch.train import TrainState

    x = torch.as_tensor(x)
    rows, layout = None, None
    if mesh is not None:
        layout = shard_state(TrainState.create(block, None), mesh).layout
        dp = mesh.shape["data"]
        if dp > 1:
            rows = RowShard(mesh.data_group, mesh.data_rank, dp)
            size = x.shape[0] // dp
            x = x[mesh.data_rank * size:(mesh.data_rank + 1) * size]
    dp = 1 if rows is None else rows.size
    with row_shard_scope(rows), collect_intermediates() as inter:
        y, _ = block(x)
        aux = moe_aux_loss(inter)
        loss = dp * (y ** 2).sum() + 0.01 * aux
    loss.backward()
    grads = {}
    for name, p in block.named_parameters():
        g = p.grad.detach().clone()
        if rows is not None:
            dist.all_reduce(g, group=rows.group)
            g /= dp
        grads[name] = (g if layout is None else layout.full(name, g)).numpy()
    loss = loss.detach()
    if rows is not None:
        dist.all_reduce(loss, group=rows.group)
        loss /= dp
    return float(loss), float(aux.detach()), grads


def ep_block_ranks(rank, world, state_paths, x, meshes):
    """:func:`moe_block_step` at each (data, expert) shape of ``meshes``
    (a product ``world``) and each capacity factor of ``state_paths``
    (``{cf: path}``), and at (data 2, expert 1) the dispatch of this rank's
    tokens, routed globally and rank-locally."""
    from avsl_tpu_torch.core.mesh import RowShard, row_shard_scope
    from avsl_tpu_torch.models.moe import make_ep_mesh

    out = {}
    for dp, ep in meshes:
        mesh = make_ep_mesh(world, experts_parallel=ep)
        assert mesh.shape == {"data": dp, "expert": ep}, mesh.shape
        for cf, path in state_paths.items():
            out[(dp, ep, cf)] = moe_block_step(load_moe_block(path, cf), x, mesh)
            if (dp, ep) == (2, 1):
                moe = load_moe_block(path, cf).mlp
                size = x.shape[0] // 2
                local = torch.as_tensor(x[mesh.data_rank * size:(mesh.data_rank + 1) * size])
                with torch.no_grad():
                    with row_shard_scope(RowShard(mesh.data_group, mesh.data_rank, 2)):
                        routed = moe.route(local).dispatch.numpy()
                    alone = moe.route(local).dispatch.numpy()
                    # two row blocks (the hoist's flattened micro-batches): this
                    # rank holds row r of each half of the global batch
                    blocks = torch.as_tensor(x[[mesh.data_rank, 2 + mesh.data_rank]])
                    with row_shard_scope(RowShard(mesh.data_group, mesh.data_rank, 2, groups=2)):
                        grouped = moe.route(blocks).dispatch.numpy()
                out[("dispatch", cf)] = (routed, alone, grouped)
    return out


# ---------------------------------------------------------------------------
# LoRA on a mesh
# ---------------------------------------------------------------------------

LORA_CFG = dict(lora_rank=4, lora_alpha=16.0, learning_rate=1e-3, warmup_steps=1,
                num_train_steps=20, add_gated_x_attn=1, prob_use_av=1.0, prob_use_a=0.5)


def train_lora(state_path, batches, mesh_kw, min_elems=None):
    """The carried tiny Whisper-Flamingo under LoRA (rank 4 on the query
    and value projections; ``cli/finetune.py``'s adapters, optimizer and
    loss) trained on ``batches`` with ``make_train_step`` on a mesh from
    ``mesh_kw`` (``n``, ``mp``, ``fsdp``; None: no mesh), with
    ``ZERO1_MIN_ELEMS`` at ``min_elems`` when given. Returns the losses,
    the adapters whole, each adapter's local Adam moment shape and the
    sequence splits the steps made."""
    import avsl_tpu_torch.core.partitioning as part
    from avsl_tpu_torch.cli.finetune import make_lora
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.models.lora import lora_loss_fn
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step
    from avsl_tpu_torch.train.optim import lora_optimizer

    if min_elems is not None:
        part.ZERO1_MIN_ELEMS = min_elems
    cfg = FlamingoTrainConfig(**LORA_CFG)
    base = load_flamingo(state_path)
    lora = make_lora(cfg, base, seed=0)
    opt, labels = lora_optimizer(lora, cfg, 20)
    state = TrainState.create(lora, opt)
    mesh = None
    if mesh_kw is not None:
        mesh = make_mesh(mesh_kw["n"], model_parallel=mesh_kw.get("mp", 1))
        part.shard_state(state, mesh, fsdp=mesh_kw.get("fsdp", False))
    loss_fn = lora_loss_fn(flamingo_loss_fn(base, train=True, **MIXING), lora)
    step = make_train_step(loss_fn, mesh=mesh, grad_accum_steps=2, param_labels=labels)
    n_scatter = _count_scatters()
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    named = dict(lora.named_parameters())
    whole = {n: (p.detach().clone() if state.layout is None else state.layout.full(n, p))
             for n, p in named.items()}
    return {"loss": losses, "adapters": {n: t.numpy() for n, t in whole.items()},
            "mu_shapes": {n: tuple(m.shape) for n, m in zip(opt.names, opt.mu)},
            "splits": n_scatter[0], "fsdp": None if state.layout is None else state.layout.fsdp}


def lora_ranks(rank, world, path, batches, variants, min_elems):
    """:func:`train_lora` for each ``(name, mesh_kw)`` of ``variants``."""
    return {name: train_lora(path, batches, kw, min_elems) for name, kw in variants}


# ---------------------------------------------------------------------------
# the AV-HuBERT heads under tensor parallelism
# ---------------------------------------------------------------------------

AVH_TP_CFG = dict(dtype="float32", vocab_size=60, n_experts=2)


def train_avhubert(head, state_path, batches, mesh_kw):
    """The tiny AV-HuBERT ``head`` model (``AVH_TP_CFG``: an even
    vocabulary, 2 experts, the tiny card's rates) with the state at
    ``state_path``, trained on ``batches`` with the fine-tune CLI's
    optimizer and loss (``cli/avhubert_ft.py``) on a (data, model) mesh
    from ``mesh_kw`` (``n``, ``mp``; None: no mesh), then its eval loss on
    the first batch. Returns the losses, the eval loss, the parameters
    whole and the names the rules split (and the grad norms)."""
    from avsl_tpu_torch.cli.avhubert_ft import cli_ctc_loss_fn, ctc_batch, make_optimizer
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.core.partitioning import describe_shardings, shard_state
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train import TrainState, make_eval_step, make_train_step
    from avsl_tpu_torch.train.objectives import avhubert_seq2seq_loss_fn

    cfg = AVHuBERTConfig.tiny_test(**AVH_TP_CFG)
    model = build_avhubert(cfg, head, device="cpu")
    model.load_state_dict(torch.load(state_path, weights_only=True))
    if head == "ctc":
        batches = [ctc_batch(b, cfg.pad_token_id) for b in batches]
        loss_fn, eval_fn = cli_ctc_loss_fn(model), cli_ctc_loss_fn(model, train=False)
    else:
        loss_fn = avhubert_seq2seq_loss_fn(model, train=True)
        eval_fn = avhubert_seq2seq_loss_fn(model, train=False)
    state = TrainState.create(model, make_optimizer(model, 1e-3, 10), seed=2)
    mesh, split = None, []
    if mesh_kw is not None:
        mesh = make_mesh(mesh_kw["n"], model_parallel=mesh_kw["mp"])
        split = sorted(n for n, _, _ in describe_shardings(model, mesh))
        shard_state(state, mesh)
    step = make_train_step(loss_fn, mesh=mesh)
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    eval_loss = float(make_eval_step(eval_fn, mesh=mesh)(state, batches[0])["loss"])
    named = dict(model.named_parameters())
    whole = {n: (p.detach() if state.layout is None else state.layout.full(n, p)).numpy().copy()
             for n, p in named.items()}
    return {"loss": losses, "grad_norm": norms, "eval_loss": eval_loss, "params": whole,
            "split": split}


def avh_tp_ranks(rank, world, paths, batches):
    """:func:`train_avhubert` for both heads at dp 1 x mp ``world``."""
    return {head: train_avhubert(head, path, batches, dict(n=world, mp=world))
            for head, path in paths.items()}


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A gloo process group of this process alone (a ``file://``
    rendezvous under ``tmp_path``), destroyed on exit: the launcher's
    group at a world size of 1."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/one_rank", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_flag_ranks(rank, world):
    """The meshes of the JAX CLIs' flags on ``world`` ranks: their shapes,
    and JAX's refusal of an axis that does not divide the ranks."""
    from types import SimpleNamespace

    from avsl_tpu_torch.cli.avhubert_ft import cli_mesh
    from avsl_tpu_torch.models.moe import make_ep_mesh

    def flags(ep, mp):
        return SimpleNamespace(experts_parallel=ep, model_parallel=mp, device="cpu")

    out = {"ep": make_ep_mesh(world, experts_parallel=world).shape,
           "ep1": make_ep_mesh(experts_parallel=1).shape,
           "both": cli_mesh(flags(2, 2)).shape, "mp": cli_mesh(flags(1, 2)).shape,
           "none": cli_mesh(flags(1, 1))}
    try:
        make_ep_mesh(world, experts_parallel=3)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def ep_state_ranks(rank, world, path, batches, ckpt):
    """The tiny CTC AV-HuBERT of ``AVH_TP_CFG`` (2 experts) trained on
    ``batches`` at (data 2, expert 2) with ZeRO-1 on 4 ranks, then
    checkpointed to ``ckpt`` and restored through ``restore_sharded`` into
    a fresh state on the same mesh and into one without a mesh. Returns
    the run's losses and grad norms, its parameters whole, the local shape
    of an expert leaf and of its Adam moment, and whether each restored
    state holds the saved tensors and moments."""
    import avsl_tpu_torch.core.partitioning as part
    from avsl_tpu_torch.cli.avhubert_ft import cli_ctc_loss_fn, ctc_batch, make_optimizer
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.models.moe import make_ep_mesh
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.checkpoints import restore_sharded, save_checkpoint

    part.ZERO1_MIN_ELEMS = 1024  # so the tiny experts' moments split, as JAX's test patches it
    cfg = AVHuBERTConfig.tiny_test(**AVH_TP_CFG)
    mesh = make_ep_mesh(world, experts_parallel=2)

    def fresh():
        model = build_avhubert(cfg, "ctc", device="cpu")
        model.load_state_dict(torch.load(path, weights_only=True))
        return TrainState.create(model, make_optimizer(model, 1e-3, 10), seed=2)

    state = part.shard_state(fresh(), mesh, zero1=True)
    step = make_train_step(cli_ctc_loss_fn(state.model), mesh=mesh)
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, ctc_batch(batch, cfg.pad_token_id))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    name = "encoder.w2v_model.encoder.layers.0.mlp.w_in"
    named = dict(state.model.named_parameters())
    i = state.optimizer.names.index(name)
    out = {"loss": losses, "grad_norm": norms,
           "params": {n: state.layout.full(n, p).numpy().copy() for n, p in named.items()},
           "w_in_local": tuple(named[name].shape), "w_in_mu": tuple(state.optimizer.mu[i].shape),
           "zero_dim": state.layout.zero.get(name), "tp_dim": state.layout.tp.get(name)}
    save_checkpoint(ckpt, state, 1)
    saved = torch.load(f"{ckpt}/step_1.pt", weights_only=True)
    for label, target_mesh in (("same_mesh", mesh), ("no_mesh", None)):
        target = restore_sharded(ckpt, fresh(), target_mesh, zero1=target_mesh is not None)
        layout = target.layout
        whole = {n: (p.detach() if layout is None else layout.full(n, p))
                 for n, p in target.model.named_parameters()}
        mu = [(t if layout is None else layout.full(n, t, moment=True))
              for n, t in zip(target.optimizer.names, target.optimizer.mu)]
        out[label] = (all(torch.equal(whole[n], saved["model"][n]) for n in whole)
                      and all(torch.equal(m, s) for m, s in zip(mu, saved["optimizer"]["mu"])))
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism (core/pipeline.py, train/pp.py)
# ---------------------------------------------------------------------------


def pp_stack(stacked: dict, heads: int):
    """A ``StackedBlocks`` of fp32 Whisper blocks over the numpy ``[L, ...]``
    arrays ``stacked`` (port keys), ``heads`` attention heads."""
    from avsl_tpu_torch.core.pipeline import StackedBlocks
    from avsl_tpu_torch.models.layers import TransformerBlock

    d, ff = stacked["attn_ln.weight"].shape[1], stacked["mlp.0.weight"].shape[1]
    block = TransformerBlock(d, heads, ff, dtype=torch.float32, param_dtype=torch.float32,
                             device="meta")
    return StackedBlocks(block, {k: torch.from_numpy(v.copy()) for k, v in stacked.items()})


def _data_rows(mesh, a):
    """This data rank's rows of the numpy array ``a`` as a tensor."""
    n = a.shape[0] // mesh.shape["data"]
    return torch.from_numpy(a[mesh.data_rank * n:(mesh.data_rank + 1) * n].copy())


def pp_schedule_ranks(rank, world, cases):
    """Each case of ``cases`` (``stages``, ``micro``, ``stacked``, ``heads``,
    ``x``, optional ``mask`` and ``grad``) through ``pipeline_apply`` on
    ``make_pp_mesh(world, stages)``, each data rank on its rows of ``x``:
    the output and, with ``grad``, the gradients of the stacked tensors
    (whole; zero outside this stage's rows) and of ``x`` under
    ``mean(y ** 2)``."""
    from avsl_tpu_torch.core.pipeline import make_pp_mesh, pipeline_apply

    out = []
    for case in cases:
        mesh = make_pp_mesh(world, stages=case["stages"])
        blocks = pp_stack(case["stacked"], case["heads"])
        x = _data_rows(mesh, case["x"]).requires_grad_(bool(case.get("grad")))
        extras = None if case.get("mask") is None else {"self_mask": _data_rows(mesh, case["mask"])}
        y = pipeline_apply(blocks.block_fn, blocks, x, mesh=mesh,
                           n_microbatches=case["micro"], extras=extras)
        rec = {"y": y.detach().numpy(), "data_rank": mesh.data_rank,
               "stage_rank": mesh.stage_rank}
        if case.get("grad"):
            (y ** 2).mean().backward()
            rec["grads"] = {k: p.grad.numpy() for k, p in blocks.named_parameters()}
            rec["gx"] = x.grad.numpy()
        out.append(rec)
    return out


class PPSandwich(torch.nn.Module):
    """JAX's ``tests/test_pp_train.py::_sandwich``: an ``embed`` table, the
    stacked blocks pipelined over ``mesh``, a mean-pooled ``head``."""

    def __init__(self, state: dict, heads: int):
        super().__init__()
        self.embed = torch.nn.Parameter(torch.from_numpy(state["embed"].copy()))
        self.head = torch.nn.Parameter(torch.from_numpy(state["head"].copy()))
        self.blocks = pp_stack({k[len("blocks."):]: v for k, v in state.items()
                                if k.startswith("blocks.")}, heads)

    def forward(self, tokens, mesh, n_microbatches: int):
        from avsl_tpu_torch.core.pipeline import pipeline_apply

        h = pipeline_apply(self.blocks.block_fn, self.blocks, self.embed[tokens], mesh=mesh,
                           n_microbatches=n_microbatches)
        return h.mean(1) @ self.head


def pp_train(state: dict, heads: int, batch: dict, mesh, lr: float, steps: int, ckpt_dir=None):
    """The sandwich of ``state`` trained ``steps`` steps on ``batch`` with
    ``constant_adamw(lr, weight_decay=0)`` (no clip) through
    ``make_train_step`` on the stage mesh ``mesh``, its state placed by
    ``shard_pp_state``: losses, grad norms, the tensors whole, this rank's
    local shapes of the tensors and of their moments (and their rows
    against the whole), and, with ``ckpt_dir``, a checkpoint written there
    after the steps."""
    import torch.nn.functional as F

    from avsl_tpu_torch.train import TrainState, make_train_step, shard_pp_state
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.optim import constant_adamw

    model = PPSandwich(state, heads)
    opt = constant_adamw(dict(model.named_parameters()), lr, weight_decay=0.0)
    train = shard_pp_state(TrainState.create(model, opt), mesh)

    def loss_fn(b, _gen):
        return F.cross_entropy(model(b["tokens"], mesh, 2), b["labels"]), {}

    step = make_train_step(loss_fn, mesh=mesh)
    losses, norms = [], []
    for _ in range(steps):
        train, m = step(train, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    layout = train.layout
    named = dict(model.named_parameters())
    whole = {n: layout.full(n, p).numpy() for n, p in named.items()}
    moments = {n: layout.full(n, mu, moment=True).numpy() for n, mu in zip(opt.names, opt.mu)}
    first, count = model.blocks.rows

    def rows(name, full):  # this stage's rows of a whole block tensor
        return full[first:first + count] if name.startswith("blocks.") else full

    local = {n: {"shape": tuple(p.shape), "mu_shape": tuple(mu.shape),
                 "rows_equal": bool(np.array_equal(p.detach().numpy(), rows(n, whole[n]))
                                    and np.array_equal(mu.numpy(), rows(n, moments[n])))}
             for (n, p), mu in zip(named.items(), opt.mu)}
    if ckpt_dir is not None:
        save_checkpoint(ckpt_dir, train, train.step)
    return {"loss": losses, "grad_norm": norms, "whole": whole, "local": local,
            "split": sorted(layout.tp), "rows": model.blocks.rows}


def pp_encoder(state_path: str, cfg_kw: dict, mel, mesh, n_microbatches: int) -> dict:
    """The port's Whisper encoder of ``state_path`` split by
    ``split_whisper_encoder_params`` and run by
    ``whisper_encoder_pp_forward`` on this data rank's rows of ``mel``."""
    from avsl_tpu_torch.core.config import WhisperConfig
    from avsl_tpu_torch.models.whisper import WhisperEncoder
    from avsl_tpu_torch.train import split_whisper_encoder_params, whisper_encoder_pp_forward

    cfg = WhisperConfig(**cfg_kw)
    enc = WhisperEncoder(cfg, device="cpu")
    enc.load_state_dict(torch.load(state_path, weights_only=True))
    stacked, stem = split_whisper_encoder_params(enc, cfg.n_audio_layer)
    with torch.no_grad():
        y = whisper_encoder_pp_forward(cfg, stem, stacked, _data_rows(mesh, mel), mesh=mesh,
                                       n_microbatches=n_microbatches)
    return {"y": y.numpy(), "stem": sorted(stem)}


def pp_train_ranks(rank, world, heads, enc_case, step_case, learn_case, ckpt_dir):
    """On ``make_pp_mesh(world, stages=2)``: the encoder case, one step of
    the sandwich (its checkpoint in ``ckpt_dir``) and the learning run."""
    from avsl_tpu_torch.core.pipeline import make_pp_mesh

    mesh = make_pp_mesh(world, stages=2)
    return {"mesh": dict(mesh.shape), "data_rank": mesh.data_rank,
            "stage_rank": mesh.stage_rank,
            "encoder": pp_encoder(*enc_case, mesh, 2),
            "step": pp_train(*step_case, mesh, lr=1e-2, steps=1, ckpt_dir=ckpt_dir),
            "learn": pp_train(*learn_case, mesh, lr=3e-2, steps=5)}
