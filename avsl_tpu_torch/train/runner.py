"""High-level training runner: step budget, gradient accumulation,
periodic teacher-forced validation with WER/CER, best-checkpoint tracking,
early stopping, resume and SIGTERM-safe exit.

Port of ``MetricLogger``, ``evaluate_wer`` and ``TrainerRunner`` from
``avsl_tpu/train/runner.py``. Metrics go to a JSONL file (the JAX runner
writes TensorBoard when TensorFlow is importable). Parameter EMA
(``ema_decay > 0``), the mesh, ZeRO and FSDP are the later training items
(ROADMAP.md queue 1, item 12) and raise; ``test_best`` (evaluating the
best checkpoint on a test split) waits for a caller.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from avsl_tpu_torch.decode.greedy import teacher_forced_predictions
from avsl_tpu_torch.decode.text_norm import normalize_text, wer_cer
from avsl_tpu_torch.train.checkpoints import latest_step, restore_checkpoint, save_checkpoint
from avsl_tpu_torch.train.loop import TrainState, make_train_step


class MetricLogger:
    """Appends ``{"step": N, metric: value, ...}`` lines to
    ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
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
    reshaped to ``[accum, micro, ...]``. ``tx`` (the JAX optimizer
    argument) is unused: the optimizer lives in the state."""

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
        if float(getattr(cfg, "ema_decay", 0.0) or 0.0) > 0.0:
            raise NotImplementedError(
                "ema_decay > 0: parameter EMA is not ported yet (ROADMAP.md queue 1, item 12)"
            )
        if partitioned_state:
            raise NotImplementedError(
                "partitioned_state: the parallel layer is not ported yet "
                "(ROADMAP.md queue 1, item 12)"
            )
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.accum = (
            int(grad_accum_steps)
            if grad_accum_steps is not None
            else int(getattr(cfg, "gradient_accumulation_steps", 1))
        )
        self.train_step = make_train_step(
            loss_fn, mesh=mesh, grad_accum_steps=self.accum, param_labels=param_labels,
            precompute_fn=precompute_fn, zero1=zero1, fsdp=fsdp,
        )
        self.eval_logits_fn = eval_logits_fn
        self.predictions_fn = predictions_fn
        self.state = init_state
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

    def maybe_resume(self) -> int:
        step = latest_step(self.ckpt_dir)
        if step is not None and getattr(self.cfg, "resume_training", False):
            self.state = restore_checkpoint(self.ckpt_dir, self.state, step)
            return step
        return 0

    def reshape_accum(self, batch: Dict[str, np.ndarray]) -> Optional[Dict[str, np.ndarray]]:
        """[B, ...] -> [accum, B//accum, ...]. A batch smaller than
        ``accum`` cannot form one micro-batch and is skipped (None);
        non-divisible batches drop the tail remainder."""
        if self.accum <= 1:
            return batch
        b = next(iter(batch.values())).shape[0]
        micro = b // self.accum
        if micro == 0:
            return None
        return {
            k: v[: micro * self.accum].reshape(self.accum, micro, *v.shape[1:])
            for k, v in batch.items()
        }

    def _evaluate(self, batches, **kw) -> Dict[str, float]:
        return evaluate_wer(lambda b: self.eval_logits_fn(self.state, b), batches,
                            self.tokenizer, predictions_fn=self.predictions_fn, **kw)

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
        while step < num_steps:
            if self._preempted:
                save_checkpoint(self.ckpt_dir, self.state, step)
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
                if wer < self.best_wer:
                    self.best_wer, self.best_step = wer, step
                    # the rolling directory keeps only a few steps, so the
                    # best one is pinned in its own
                    save_checkpoint(self._best_dir, self.state, step)
                    self._evals_since_best = 0
                else:
                    self._evals_since_best += 1
                    if self.early_stop_patience and self._evals_since_best >= self.early_stop_patience:
                        break
        save_checkpoint(self.ckpt_dir, self.state, step)
        return {
            "final_step": step,
            "best_wer": self.best_wer,
            "best_step": self.best_step,
            "history": history,
            "preempted": self._preempted,
        }
