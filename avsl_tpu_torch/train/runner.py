"""High-level training runner: step budget, gradient accumulation,
periodic teacher-forced validation with WER/CER, best-checkpoint tracking,
early stopping, resume and SIGTERM-safe exit.

Port of ``MetricLogger``, ``evaluate_wer`` and ``TrainerRunner`` (with
the frozen-tower hoist and ``test_best``) from ``avsl_tpu/train/runner.py``.
Metrics go to a JSONL file (the JAX runner writes TensorBoard when
TensorFlow is importable). With ``ema_decay > 0`` an exponential moving
average of the trained tensors follows every train-step call (every
micro-batch under ``MultiSteps``, as JAX applies ``ema_update`` after each
``train_step``); validation and the pinned best checkpoint use it, the
rolling checkpoints keep the raw state, and a resume restarts it from the
restored tensors.

With a ``mesh`` (``core/mesh.py``) the runner puts its state there
(``core/partitioning.py::shard_state``: tensor parallelism from the rules,
``zero1``, ``fsdp``) and every rank runs the same loop on the same global
batches: the step takes each rank's rows, validation gathers every rank's
logits so each computes the same WER and picks the same best step,
checkpoints are collective and written by rank 0 alone (the whole
logical state, restored into any layout), as are the metrics, and the EMA
follows each rank's part of the trained tensors.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from avsl_tpu_torch.core.mesh import (
    DATA_AXIS,
    ShardedBatch,
    gather_from_group,
    rank,
    shard_batch,
    world_size,
)
from avsl_tpu_torch.core.partitioning import local_tensor, shard_state
from avsl_tpu_torch.decode.greedy import teacher_forced_predictions
from avsl_tpu_torch.decode.text_norm import normalize_text, wer_cer
from avsl_tpu_torch.train.checkpoints import (
    latest_step,
    pin_checkpoint,
    restore_checkpoint,
    restore_params_only,
    save_checkpoint,
)
from avsl_tpu_torch.train.ema import ema_update
from avsl_tpu_torch.train.loop import TrainState, make_train_step


class MetricLogger:
    """Appends ``{"step": N, metric: value, ...}`` lines to
    ``<log_dir>/metrics.jsonl``; in a process group, on rank 0 only."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.enabled = rank() == 0
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")


def evaluate_wer(
    predict_logits: Callable[[Dict[str, Any]], torch.Tensor],
    batches: Iterable[Dict[str, Any]],
    tokenizer,
    max_batches: Optional[int] = None,
    prefix: str = "val",
    predictions_fn: Optional[Callable[[Any], Any]] = None,
) -> Dict[str, float]:
    """Teacher-forced argmax eval with EOT masking + corpus WER/CER, and
    the teacher-forced CE over the non-pad labels as ``<prefix>/loss``.

    ``predictions_fn(logits) -> token rows`` overrides the seq2seq
    teacher-forced argmax."""
    hyps, refs, losses = [], [], []
    special = tokenizer.special_token_set
    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        logits = predict_logits(batch)
        if predictions_fn is not None:
            tokens = predictions_fn(logits)
        else:
            tokens = teacher_forced_predictions(logits, tokenizer.eot).cpu().numpy()
            lab = np.asarray(batch["labels"])
            lg = logits.float().cpu().numpy()
            if lg.ndim == 3 and lg.shape[:2] == lab.shape:
                m = lab >= 0
                if m.any():
                    row = lg - lg.max(-1, keepdims=True)
                    lse = row - np.log(np.exp(row).sum(-1, keepdims=True))
                    ll = np.take_along_axis(lse, np.maximum(lab, 0)[..., None], -1)[..., 0]
                    losses.append(float(-(ll * m).sum() / m.sum()))
        labels = np.asarray(batch["labels"])
        for o_row, l_row in zip(tokens, labels):
            o_ids = [int(t) for t in o_row if int(t) >= 0 and int(t) not in special]
            l_ids = [int(t) for t in l_row if int(t) >= 0 and int(t) not in special]
            hyps.append(normalize_text(tokenizer.decode(o_ids)))
            refs.append(normalize_text(tokenizer.decode(l_ids)))
    pairs = [(h, r) for h, r in zip(hyps, refs) if h.strip() or r.strip()]
    if not pairs:
        out = {f"{prefix}/wer_av": 1.0, f"{prefix}/cer_av": 1.0}
    else:
        wer, cer = wer_cer([h for h, _ in pairs], [r for _, r in pairs])
        out = {f"{prefix}/wer_av": wer, f"{prefix}/cer_av": cer}
    if losses:
        out[f"{prefix}/loss"] = float(np.mean(losses))
    return out


class TrainerRunner:
    """Step-budgeted training with periodic validation + checkpointing.

    ``loss_fn`` and ``init_state`` are as for
    :func:`~avsl_tpu_torch.train.loop.make_train_step`;
    ``eval_logits_fn(state, batch)`` gives teacher-forced logits. Batches
    from ``fit``'s ``train_batches`` hold ``accum × micro`` items and are
    reshaped to ``[accum, micro, ...]``; with ``grad_accum_steps=1`` and a
    :class:`~avsl_tpu_torch.train.optim.MultiSteps` optimizer in the state
    each batch is one micro-batch of any size and the optimizer
    accumulates across batches (and across epochs). Steps, validation and
    checkpoints count train-step calls, i.e. micro-batches. A validation
    saves the state once: the best step is a hard link to that file
    (:func:`~avsl_tpu_torch.train.checkpoints.pin_checkpoint`), and the end
    of ``fit`` writes no second copy of a step just saved. ``tx`` (the JAX
    optimizer argument) is unused: the optimizer lives in the state.
    ``precompute_fn`` (the frozen-tower hoist, gated by the caller) runs
    once a step before the micro-steps, inside the step.

    ``cfg.ema_decay > 0`` keeps an EMA of the tensors the optimizer trains
    (JAX's covers its whole ``params`` tree; the frozen tensors, which
    JAX's EMA leaves equal up to rounding, are the live ones here, see
    ROADMAP.md §3). ``evaluate`` and ``best/`` see it; ``ema`` holds it.
    On a model axis above 1 the step carries sequence parallelism, as
    JAX's runner's does (``make_train_step``'s default)."""

    def __init__(
        self,
        loss_fn,
        eval_logits_fn: Callable[[TrainState, Dict[str, Any]], torch.Tensor],
        tx,
        init_state: TrainState,
        tokenizer,
        cfg,
        mesh=None,
        log_dir: str = "output/train",
        ckpt_dir: str = "checkpoints/run",
        grad_accum_steps: Optional[int] = None,
        predictions_fn=None,
        partitioned_state: bool = False,
        zero1: bool = False,
        fsdp: bool = False,
        param_labels=None,
        precompute_fn=None,
    ):
        del tx
        self.mesh = mesh
        # fsdp subsumes zero1; tensor parallelism follows the rules on any
        # model axis above 1, so partitioned_state adds nothing to them
        self.fsdp = bool(fsdp) and mesh is not None
        self.zero1 = bool(zero1) and mesh is not None and not self.fsdp
        self.partitioned = (bool(partitioned_state) or self.zero1 or self.fsdp) \
            and mesh is not None
        if mesh is not None and init_state.layout is None:
            shard_state(init_state, mesh, zero1=self.zero1, fsdp=self.fsdp)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.accum = (
            int(grad_accum_steps)
            if grad_accum_steps is not None
            else int(getattr(cfg, "gradient_accumulation_steps", 1))
        )
        self.train_step = make_train_step(
            loss_fn, mesh=mesh, grad_accum_steps=self.accum, param_labels=param_labels,
            precompute_fn=precompute_fn, zero1=self.zero1, fsdp=self.fsdp,
        )
        self.eval_logits_fn = eval_logits_fn
        self.predictions_fn = predictions_fn
        self.state = init_state
        self.ema_decay = float(getattr(cfg, "ema_decay", 0.0) or 0.0)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self._reset_ema()
        self.logger = MetricLogger(log_dir)
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self._best_dir = os.path.join(self.ckpt_dir, "best")
        self.best_wer = float("inf")
        self.best_step = -1
        # early stopping on the monitored metric; 0 disables
        self.early_stop_patience = int(getattr(cfg, "early_stop_patience", 0) or 0)
        self._evals_since_best = 0
        self._preempted = False

    def _install_preemption_handler(self):
        """On SIGTERM, mark a flag; the step loop checkpoints at the next
        step boundary and exits cleanly (resumable via
        ``resume_training``). Returns a callable that restores the previous
        handler. No-op outside the main thread."""
        import signal
        import threading

        self._preempted = False
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def on_term(signum, frame):
            self._preempted = True

        prev = signal.signal(signal.SIGTERM, on_term)
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _trained(self) -> Dict[str, torch.Tensor]:
        """The tensors the optimizer updates, by name (without an
        optimizer, every parameter that takes a gradient); on a mesh, this
        rank's parts of them."""
        opt = self.state.optimizer
        if opt is not None:
            named = dict(zip(opt.names, opt.params))
        else:
            named = {n: p for n, p in self.state.model.named_parameters() if p.requires_grad}
        return {n: local_tensor(p) for n, p in named.items()}

    def _reset_ema(self) -> None:
        if self.ema_decay > 0.0:
            with torch.no_grad():
                self.ema = {n: p.detach().clone() for n, p in self._trained().items()}

    @contextlib.contextmanager
    def _ema_weights(self):
        """Within the block the trained tensors hold the EMA (their storage
        swapped, no copy; a DTensor's local shard by value); without EMA,
        nothing changes."""
        if self.ema is None:
            yield
            return
        live = self._trained()
        fsdp = self.state.layout is not None and self.state.layout.fsdp

        @torch.no_grad()
        def swap():
            for name, p in live.items():
                if fsdp:
                    held = p.clone()
                    p.copy_(self.ema[name])
                    self.ema[name].copy_(held)
                else:
                    p.data, self.ema[name] = self.ema[name], p.data

        swap()
        try:
            yield
        finally:
            swap()

    def maybe_resume(self) -> int:
        step = latest_step(self.ckpt_dir)
        if step is not None and getattr(self.cfg, "resume_training", False):
            self.state = restore_checkpoint(self.ckpt_dir, self.state, step)
            self._reset_ema()
            return step
        return 0

    def reshape_accum(self, batch: Dict[str, np.ndarray]) -> Optional[Dict[str, np.ndarray]]:
        """[B, ...] -> [accum, B//accum, ...]. A batch smaller than
        ``accum`` cannot form one micro-batch and is skipped (None);
        non-divisible batches drop the tail remainder."""
        if self.accum <= 1:
            return batch
        if isinstance(batch, ShardedBatch):
            raise ValueError("a batch already cut into a rank's rows cannot be reshaped to "
                             "[accum, micro]: hand the runner global batches")
        b = next(iter(batch.values())).shape[0]
        micro = b // self.accum
        if micro == 0:
            return None
        return {
            k: v[: micro * self.accum].reshape(self.accum, micro, *v.shape[1:])
            for k, v in batch.items()
        }

    def _logits(self, batch: Dict[str, Any]) -> torch.Tensor:
        """``eval_logits_fn`` on the global batch: on a mesh each data rank
        runs its rows and the logits of every rank are gathered (a batch
        that does not divide the data axis runs whole on every rank)."""
        if self.mesh is None:
            return self.eval_logits_fn(self.state, batch)
        local = shard_batch(self.mesh, batch)
        logits = self.eval_logits_fn(self.state, local)
        if "labels" not in local.sharded or self.mesh.shape[DATA_AXIS] <= 1:
            return logits
        return gather_from_group(logits.contiguous(), self.mesh.data_group, 0)

    def _evaluate(self, batches, **kw) -> Dict[str, float]:
        """WER on ``batches`` with the EMA weights when there are some."""
        with self._ema_weights():
            return evaluate_wer(self._logits, batches, self.tokenizer,
                                predictions_fn=self.predictions_fn, **kw)

    def _preempted_anywhere(self) -> bool:
        """Whether any rank got SIGTERM (all ranks checkpoint together)."""
        if world_size() <= 1:
            return self._preempted
        device = local_tensor(next(self.state.model.parameters())).device
        flag = torch.tensor([float(self._preempted)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def fit(
        self,
        train_batches: Callable[[int], Iterator[Dict[str, np.ndarray]]],
        val_batches: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]] = None,
        num_steps: Optional[int] = None,
        validate_every: Optional[int] = None,
        sanity_val_steps: int = 0,
    ) -> Dict[str, Any]:
        cfg = self.cfg
        num_steps = num_steps or int(getattr(cfg, "num_train_steps", 1000))
        validate_every = validate_every or int(getattr(cfg, "validate_every_n_batches", 1000))
        if sanity_val_steps and val_batches is not None:
            self.logger.log(0, self._evaluate(val_batches(), max_batches=sanity_val_steps))
        step = self.maybe_resume()
        restore_signal = self._install_preemption_handler()
        try:
            return self._fit_loop(train_batches, val_batches, step, num_steps, validate_every)
        finally:
            restore_signal()

    def _fit_loop(self, train_batches, val_batches, step, num_steps, validate_every):
        epoch, it = 0, train_batches(0)
        t0, last_logged_step, history = time.time(), step, []
        saved = None  # the step last written to ckpt_dir by this loop
        while step < num_steps:
            if self._preempted_anywhere():
                save_checkpoint(self.ckpt_dir, self.state, step)
                saved = step
                self.logger.log(step, {"train/preempted": 1.0})
                break
            try:
                batch = next(it)
            except StopIteration:
                epoch += 1
                it = train_batches(epoch)
                continue
            reshaped = self.reshape_accum(batch)
            if reshaped is None:  # tail batch smaller than accum: drop_last
                continue
            self.state, metrics = self.train_step(self.state, reshaped)
            if self.ema is not None:
                with torch.no_grad():
                    ema_update(self.ema, self._trained(), self.ema_decay)
            step += 1
            if step % 10 == 0 or step == num_steps:
                logd = {f"train/{k}": float(v) for k, v in metrics.items()}
                logd["train/steps_per_sec"] = (step - last_logged_step) / max(time.time() - t0, 1e-6)
                t0, last_logged_step = time.time(), step
                self.logger.log(step, logd)
                history.append((step, float(metrics["loss"])))
            if val_batches is not None and step % validate_every == 0:
                m = self._evaluate(val_batches())
                m["val/train_loss"] = float(metrics["loss"])
                self.logger.log(step, m)
                wer = m.get("val/wer_av", 1.0)
                save_checkpoint(self.ckpt_dir, self.state, step)
                saved = step
                if wer < self.best_wer:
                    self.best_wer, self.best_step = wer, step
                    # the rolling directory keeps only a few steps, so the
                    # best one is pinned in its own; with EMA it holds the
                    # evaluated (averaged) weights, a checkpoint of its own
                    if self.ema is None:
                        pin_checkpoint(self.ckpt_dir, self._best_dir, step)
                    else:
                        with self._ema_weights():
                            save_checkpoint(self._best_dir, self.state, step)
                    self._evals_since_best = 0
                else:
                    self._evals_since_best += 1
                    if self.early_stop_patience and self._evals_since_best >= self.early_stop_patience:
                        break
        if saved != step:  # the state has not moved since a save at this step
            save_checkpoint(self.ckpt_dir, self.state, step)
        return {
            "final_step": step,
            "best_wer": self.best_wer,
            "best_step": self.best_step,
            "history": history,
            "preempted": self._preempted,
        }

    def test_best(
        self,
        test_batches: Callable[[], Iterator[Dict[str, np.ndarray]]],
        prefix: str = "test",
        max_batches: Optional[int] = None,
    ) -> Dict[str, float]:
        """Evaluate the best checkpoint (by ``val/wer_av``) on a held-out
        split, the reference's ``trainer.test(ckpt_path='best')``: the
        latest checkpoint when no validation picked a best step, the
        in-memory state when there is no checkpoint. The model's own
        weights are put back afterwards."""
        step = self.best_step if self.best_step >= 0 else latest_step(self.ckpt_dir)
        model, saved = self.state.model, None
        if step is not None and step >= 0:
            # the best step lives in its own pinned directory; the rolling
            # one holds the plain latest step
            for directory in (self._best_dir, self.ckpt_dir):
                try:
                    saved = restore_params_only(directory, step)
                except (OSError, RuntimeError, KeyError):
                    continue
                if saved is not None:
                    break
            if saved is None:
                print(f"warning: checkpoint for step {step} not restorable; "
                      "evaluating the in-memory (final) state instead")
                step = None
        live = None
        layout = self.state.layout
        if saved is not None:
            live = {k: local_tensor(v).detach().to("cpu", copy=True)
                    for k, v in model.state_dict().items()}
            if layout is None:
                model.load_state_dict(saved)
            else:
                layout.load_model_state(model, saved)
        try:
            m = evaluate_wer(self._logits, test_batches(), self.tokenizer,
                             max_batches=max_batches, prefix=prefix,
                             predictions_fn=self.predictions_fn)
        finally:
            if live is not None:
                with torch.no_grad():
                    for k, v in model.state_dict(keep_vars=True).items():
                        local_tensor(v).copy_(live[k])
        self.logger.log(step or 0, m)
        return m
