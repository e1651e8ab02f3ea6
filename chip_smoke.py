"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with a CUDA card, ``nvcc`` and ``nvidia-smi``. Phases, each of which
raises on failure:

1. header: the card's name and power limit; TF32 off for the comparisons;
2. build: ``nvcc`` compiles the flash-attention forward and backward
   kernels from ``avsl_tpu_torch/csrc``, one process per source, together;
3. kernels against plain: the forward kernel (K1) and its plain PyTorch
   version at the shapes of the serving path; K1's row statistics against
   the plain row max and sum; the backward kernel (K2) against its plain
   version at the shapes of the training path (and the serving encoder's);
   each with times (CUDA events, median of 20), the yardstick library call
   and the least time the card could take;
4. small references: the tiny test model's teacher-forced logits on the
   card (through K1) against the same weights on the CPU (plain); one
   bf16 cached cross-attention decode step against upcast fp32 operands;
   and the tiny fp32 model trained 3 accumulated steps on the card
   (K1 + K2) against the CPU (per-step loss and grad norm, step-1
   gradients);
5. serving path: Whisper large-v2 widths (bf16, seeded random weights,
   51865-token vocab) serving 16 synthetic 30 s windows through
   ``StreamingTranscriber`` at batch 8, with K1's launch count read around
   exactly that run (and no row statistics written), then a per-stage
   breakdown of one batch and a torch.profiler trace of its encoder and of
   16 decode steps (device busy time, idle share, top kernels);
6. training path: Whisper large-v2 widths, audio-only, fp32 weights and
   Adam state under bf16 compute, 51866-token vocab, the training YAML's
   settings (batch 1 x accumulation 16, 10 s windows, dropout 0.1,
   SpecAugment ls-basic, lr 1e-5 with 1000 warmup steps) composed as the
   port's ``whisper_ft`` composes them: 3 optimizer steps over 48
   synthetic items with K1 and K2 launches read around exactly those
   steps, then one step broken into forward, backward and optimizer and
   one traced step.

It prints the kernel list, the card's name and power limit and, last,
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data sheet (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SOURCES = ("flash_attn_fwd", "flash_attn_bwd")
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FP32_TOL = dict(atol=1e-4, rtol=0.0)
# K2 vs plain in fp32: both sum up to Tq or Tk fp32 products, in other
# orders, and the kernel's weights come from the forward's online m and l
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
# K1's row statistics vs the plain row max and sum: fp32 sums in other orders
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
# tiny fp32 train step, card (kernels) vs CPU (plain): sums over 2 x 2 items
# and 4 blocks in other orders, and K2 recomputes P from K1's online m, l
SMALL_TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
TRAIN_CONFIG = "configs/ami_whisper_flamingo_large.yaml"
LARGE_V2_VOCAB = 51865 + 1  # large-v2's vocab plus <laugh>
TRAIN_STEPS = 3


T_START = time.perf_counter()


def log(obj) -> None:
    """Print a dict as one JSON line, stamped with the script's elapsed
    seconds, or anything else as it is."""
    if isinstance(obj, dict):
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(b, h, tq, tk, d, dtype, causal, lengths, backward=False):
    """(bound_ms, bound_by, flops, bytes): the larger of the needed
    operations over the dtype's peak and each input read plus each output
    written once over the memory rate.

    Work counts the (q, key) pairs this data needs: k <= q under the
    causal mask and min(len, Tk) keys for a length. The forward does 2
    products a pair (4*D FLOP) and on a length-0 row only the mean of V;
    the backward does 5 (10*D FLOP; the JAX CostEstimate says 11) and on
    a length-0 row forms dS at every key. The forward moves Q, K, V and O;
    the backward reads Q, K, V, O, dO and the fp32 row statistics m and l
    and writes dQ, dK and dV."""
    per_pair = 10 * d if backward else 4 * d
    flops = 0
    for n in (lengths if lengths is not None else [None] * b):
        if n is not None and n <= 0:
            flops += h * tq * tk * (per_pair if backward else 2 * d)
            continue
        keys = tk if n is None else min(n, tk)
        pairs = sum(min(qi + 1, keys) for qi in range(tq)) if causal else tq * keys
        flops += h * pairs * per_pair
    itemsize = torch.tensor([], dtype=dtype).element_size()
    if backward:
        nbytes = (4 * b * tq * h * d + 4 * b * tk * h * d) * itemsize + 2 * b * h * tq * 4
    else:
        nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * itemsize
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def check_attention_case(name, b, h, tq, tk, d, dtype, causal=False, lengths=None, seed=0):
    from avsl_tpu_torch.kernels.attention import flash_attention_fwd_cuda, reference_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    mk = lambda t: torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = mk(tq), mk(tk), mk(tk)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def kernel():
        return flash_attention_fwd_cuda(q, k, v, lens, causal)

    def plain():
        return reference_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lens, causal
        ).transpose(1, 2)

    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if lens is not None:
        mask = (torch.arange(tk, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal
        )

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    limit = tol["atol"] + tol["rtol"] * want.float().abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name}: kernel vs plain max_abs_err {err.max().item():.3e} over {tol}")
    if lengths is not None:
        for bi, n in enumerate(lengths):
            if n == 0:  # uniform weights over all Tk keys: the mean of V
                mean_v = v[bi].float().mean(dim=0)  # [H, D]
                row_err = (got[bi].float() - mean_v[None]).abs().max().item()
                if row_err > tol["atol"]:
                    raise AssertionError(f"{name}: length-0 row differs from mean(V) by {row_err:.3e}")
    bound_ms, bound_by, flops, nbytes = attention_bound(b, h, tq, tk, d, dtype, causal, lengths)
    rec = {
        "case": name, "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "D": d},
        "dtype": str(dtype).replace("torch.", ""), "causal": causal, "lengths": lengths,
        "max_abs_err": err.max().item(), "tolerance": tol,
        "kernel_ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
        "library_ms": cuda_ms(library), "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes,
    }
    rec["kernel_tflops"] = flops / rec["kernel_ms"] / 1e9
    log(rec)
    return rec


def phase_kernels():
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        check_attention_case("a_encoder_bf16", 8, 20, 1500, 1500, 64, bf16),
        check_attention_case("a_encoder_fp32", 8, 20, 1500, 1500, 64, f32),
        check_attention_case("b_decoder_self_causal", 8, 20, 448, 448, 64, bf16, causal=True),
        check_attention_case("c_cross", 8, 20, 70, 1500, 64, bf16),
        check_attention_case("d_ragged_lengths", 4, 20, 1003, 1003, 64, bf16,
                             lengths=[0, 1003, 517, 1]),
        check_attention_case("e_tiny_head_dim", 8, 2, 200, 200, 32, f32),
    ]


def _qkv(gen, b, h, tq, tk, d, dtype, lengths):
    mk = lambda t: torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)  # noqa: E731
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return mk(tq), mk(tk), mk(tk), mk(tq), lens


def check_attention_stats(name, b, h, tq, tk, d, dtype, causal=False, lengths=None, seed=0):
    """The forward kernel's row statistics (row max m and row sum l of
    exp(x - m), fp32) against the plain row max and row sum."""
    from avsl_tpu_torch.kernels.attention import flash_attention_fwd_cuda, reference_attention_stats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, _, _, lens = _qkv(gen, b, h, tq, tk, d, dtype, lengths)
    _, m, l = flash_attention_fwd_cuda(q, k, k, lens, causal, stats=True)
    want_m, want_l = reference_attention_stats(q.transpose(1, 2), k.transpose(1, 2), lens, causal)
    torch.cuda.synchronize()
    rec = {"phase": "k1_row_statistics", "case": name,
           "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "D": d},
           "dtype": str(dtype).replace("torch.", ""), "causal": causal, "lengths": lengths,
           "tolerance": STATS_TOL}
    for key, got, want in (("m", m, want_m), ("l", l, want_l)):
        err = (got - want).abs()
        rec[f"{key}_max_abs_err"] = err.max().item()
        rec[f"{key}_max_rel_err"] = (err / want.abs().clamp_min(1e-30)).max().item()
        if not bool((err <= STATS_TOL["atol"] + STATS_TOL["rtol"] * want.abs()).all()):
            raise AssertionError(f"{name}: row statistic {key} differs from plain by "
                                 f"{rec[f'{key}_max_abs_err']:.3e}")
    log(rec)


def check_attention_bwd_case(name, b, h, tq, tk, d, dtype, causal=False, lengths=None, seed=0):
    """The backward kernel against its plain version on the same tensors
    (dQ, dK, dV), with times (CUDA events, median of 20), the backward of
    scaled_dot_product_attention as the yardstick, and the bound."""
    from avsl_tpu_torch.kernels.attention import (
        flash_attention_bwd_cuda,
        flash_attention_fwd_cuda,
        reference_attention_bwd,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, g, lens = _qkv(gen, b, h, tq, tk, d, dtype, lengths)
    o, m, l = flash_attention_fwd_cuda(q, k, v, lens, causal, stats=True)

    def kernel():
        return flash_attention_bwd_cuda(q, k, v, o, g, m, l, lens, causal)

    def plain():
        heads = (t.transpose(1, 2) for t in (q, k, v, o, g))
        return [t.transpose(1, 2) for t in reference_attention_bwd(*heads, lens, causal)]

    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = None
    if lens is not None:
        mask = (torch.arange(tk, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=causal)
    gh = g.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else BWD_FP32_TOL
    rec = {"phase": "k2_against_plain", "case": name,
           "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "D": d},
           "dtype": str(dtype).replace("torch.", ""), "causal": causal, "lengths": lengths,
           "tolerance": tol}
    worst = 0.0
    for key, x, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name}: kernel {key} is not finite")
        err = (x.float() - w.float()).abs()
        rec[f"{key}_max_abs_err"] = err.max().item()
        worst = max(worst, rec[f"{key}_max_abs_err"])
        if not bool((err <= tol["atol"] + tol["rtol"] * w.float().abs()).all()):
            raise AssertionError(f"{name}: kernel {key} vs plain max_abs_err "
                                 f"{rec[f'{key}_max_abs_err']:.3e} over {tol}")
    bound_ms, bound_by, flops, nbytes = attention_bound(
        b, h, tq, tk, d, dtype, causal, lengths, backward=True)
    rec.update({"max_abs_err": worst, "kernel_ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(library), "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": nbytes})
    rec["kernel_tflops"] = flops / rec["kernel_ms"] / 1e9
    log(rec)
    return rec


def phase_kernel_stats():
    bf16 = torch.bfloat16
    check_attention_stats("train_encoder", 1, 20, 500, 500, 64, bf16)
    check_attention_stats("decoder_self_causal", 1, 20, 210, 210, 64, bf16, causal=True)
    check_attention_stats("ragged_lengths", 4, 20, 1003, 1003, 64, bf16, lengths=[0, 1003, 517, 1])


def phase_kernels_bwd(label_len: int):
    """K2 against its plain version at the training path's shapes
    (``label_len`` is the longest decoder sequence of the train path) and
    at the serving encoder shape, beside K1's row."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        check_attention_bwd_case("a_train_encoder_bf16", 1, 20, 500, 500, 64, bf16),
        check_attention_bwd_case("a_train_encoder_fp32", 1, 20, 500, 500, 64, f32),
        check_attention_bwd_case("b_decoder_self_causal", 1, 20, label_len, label_len, 64, bf16,
                                 causal=True),
        check_attention_bwd_case("c_cross", 1, 20, label_len, 500, 64, bf16),
        check_attention_bwd_case("d_ragged_lengths", 4, 20, 1003, 1003, 64, bf16,
                                 lengths=[0, 1003, 517, 1]),
        check_attention_bwd_case("e_tiny_head_dim", 8, 2, 200, 200, 32, f32),
        check_attention_bwd_case("f_serving_encoder_bf16", 8, 20, 1500, 1500, 64, bf16),
    ]


def phase_small_reference():
    """Tiny test model: teacher-forced logits on the card (kernel, fp32)
    against the same weights on the CPU (plain path)."""
    from avsl_tpu_torch.models import build_whisper_flamingo

    cpu_model, cfg = build_whisper_flamingo(
        "test", vocab_size=300, add_gated_x_attn=0, dtype="float32", device="cpu", seed=3
    )
    gpu_model, _ = build_whisper_flamingo(
        "test", vocab_size=300, add_gated_x_attn=0, dtype="float32", device="cuda", seed=3
    )
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(4)
    mel = torch.from_numpy(rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 300, size=(2, 7)))
    with torch.inference_mode():
        want = cpu_model(mel, toks)
        got = gpu_model(mel.cuda(), toks.cuda()).cpu()
    err = (got - want).abs().max().item()
    log({"phase": "small_reference", "logits_shape": list(got.shape), "max_abs_err": err,
         "atol": 1e-3})
    if not torch.isfinite(got).all() or err > 1e-3:
        raise AssertionError(f"tiny model card-vs-cpu logits differ by {err:.3e}")


def phase_cached_attention():
    """One decode step of cross-attention at the main path's shape (B=8,
    H=20, Q=1, Tk=1500, D=64, bf16, head-major cache) as the decoder runs
    it, against the same math on operands upcast to fp32 first."""
    from avsl_tpu_torch.models.layers import head_major_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b, h, tk, d = 8, 20, 1500, 64
    q = torch.randn((b, h, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))

    def upcast():
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(w.float(), v.float()).to(q.dtype)

    got, want = head_major_attention(q, k, v), upcast()
    err = (got.float() - want.float()).abs()
    limit = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.float().abs()
    log({"phase": "cached_attention", "shape": {"B": b, "H": h, "Tq": 1, "Tk": tk, "D": d},
         "max_abs_err": err.max().item(), "tolerance": BF16_TOL,
         "ms": cuda_ms(lambda: head_major_attention(q, k, v)), "upcast_ms": cuda_ms(upcast)})
    if not torch.isfinite(got.float()).all() or not bool((err <= limit).all()):
        raise AssertionError(f"cached attention differs from upcast by {err.max().item():.3e}")


def phase_main_path(card: str):
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.decode.greedy import greedy_decode_scored
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.kernels.attention import fused_attention
    from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
    from avsl_tpu_torch.models import build_whisper_flamingo

    t0 = time.perf_counter()
    model, cfg = build_whisper_flamingo(
        "large-v2", add_gated_x_attn=0, use_av_hubert_encoder=False,
        dtype="bfloat16", device="cuda", seed=0,
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log({"phase": "build_model", "model": cfg.name, "params": n_params,
         "n_vocab": cfg.n_vocab, "seconds": time.perf_counter() - t0})
    batch, n_items, max_new = 8, 16, 64
    tr = StreamingTranscriber(model, ByteTokenizer(), audio_max_length=480000,
                              batch_size=batch, max_new_tokens=max_new)
    rng = np.random.default_rng(0)
    items = [
        {"id": f"seg{i:02d}",
         "audio": (0.1 * rng.standard_normal(int(rng.integers(320000, 480001)))).astype(np.float32)}
        for i in range(n_items)
    ]
    tr.transcribe_batch(items[:batch])  # warm-up: cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    from avsl_tpu_torch.kernels import attention

    stats_writes = []
    unwrapped = attention.flash_attention_fwd_cuda

    def counting(*args, **kw):  # records which K1 launches write row statistics
        stats_writes.append(bool(kw.get("stats", False)))
        return unwrapped(*args, **kw)

    attention.flash_attention_fwd_cuda = counting
    fused_attention.launches = attention.fused_attention_bwd.launches = 0
    try:
        t0 = time.perf_counter()
        results = tr.transcribe(items)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        attention.flash_attention_fwd_cuda = unwrapped
    launches = fused_attention.launches
    if any(stats_writes) or attention.fused_attention_bwd.launches:
        raise AssertionError("the serving path wrote row statistics or ran the backward kernel")

    n_batches = math.ceil(n_items / batch)
    if len(results) != n_items:
        raise AssertionError(f"{len(results)} results for {n_items} items")
    if not all(math.isfinite(r.avg_logprob) for r in results):
        raise AssertionError("non-finite avg_logprob")
    if any(len(r.tokens) != max_new for r in results):
        raise AssertionError("token rows of the wrong length")
    if launches != cfg.n_audio_layer * n_batches:
        raise AssertionError(f"flash-attention launches {launches} != {cfg.n_audio_layer * n_batches}")
    n_tokens = sum(next((i + 1 for i, t in enumerate(r.tokens) if t == tr.tokenizer.eot), max_new)
                   for r in results)
    log({"phase": "main_path", "card": card, "items": n_items, "batches": n_batches,
         "seconds": seconds, "seconds_per_batch": seconds / n_batches,
         "segments_per_s": n_items / seconds, "decode_tokens": n_tokens,
         "tokens_per_s_end_to_end": n_tokens / seconds,
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "flash_attention_launches": launches, "row_statistics_written": sum(stats_writes),
         "avg_logprob_first": results[0].avg_logprob})

    # per-stage breakdown of one batch (host clock, synchronised per stage)
    audio = tr._prepare_batch(items[:batch])
    stages = {}
    with torch.inference_mode():
        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = time.perf_counter() - t
            return out

        x = timed("h2d", lambda: torch.from_numpy(audio).cuda())
        mel = timed("log_mel", lambda: log_mel_spectrogram(x, n_mels=cfg.n_mels))
        feats, _ = timed("encoder", lambda: model.encode(mel))
        cache = timed("cache_build", lambda: model.init_decode_cache(
            feats, None, max_new + tr._prompt.shape[1] + 2))
        timed("decode", lambda: greedy_decode_scored(
            lambda tok, c: model.decode(tok, None, None, c), cache, tr._prompt,
            max_new, tr.tokenizer.eot))
        # traced run (torch.profiler): device busy time against wall time;
        # the decode trace covers a quarter of the steps to keep it short
        traced_steps = max_new // 4
        traced = {
            "encoder": traced_run(lambda: model.encode(mel)),
            "decode": traced_run(lambda: greedy_decode_scored(
                lambda tok, c: model.decode(tok, None, None, c),
                model.init_decode_cache(feats, None, traced_steps + tr._prompt.shape[1] + 2),
                tr._prompt, traced_steps, tr.tokenizer.eot)),
        }
    log({"phase": "stage_breakdown", "card": card, "batch": batch, "stage_seconds": stages,
         "decode_steps": max_new, "decode_tokens_per_s": batch * max_new / stages["decode"]})
    log({"phase": "traced_stages", "card": card, "batch": batch,
         "decode_steps_traced": traced_steps, **traced})
    return launches


def _tiny_train_pair(seed: int = 3):
    """The tiny fp32 test model (dropout 0) on the card and on the CPU with
    the same weights, each with its optimizer, state and train step
    (accumulation 2, no SpecAugment)."""
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.models import build_whisper_flamingo
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step, whisper_optimizer

    tcfg = FlamingoTrainConfig(learning_rate=1e-3, warmup_steps=1, num_train_steps=10)
    pair = []
    for device in ("cuda", "cpu"):
        model, cfg = build_whisper_flamingo(
            "test", vocab_size=300, add_gated_x_attn=0, dtype="float32", param_dtype="float32",
            device=device, seed=seed)
        if pair:
            model.load_state_dict(pair[0][0].state_dict())
        opt, _ = whisper_optimizer(model, tcfg, 10)
        loss_fn = flamingo_loss_fn(model, train=True)
        pair.append((model, loss_fn, TrainState.create(model, opt),
                     make_train_step(loss_fn, grad_accum_steps=2)))
    return pair, cfg


def phase_small_train_reference():
    """The tiny fp32 model trained 3 optimizer steps of 2 micro-batches on
    the card (K1 + K2) and on the CPU (plain versions) from the same
    weights: per-step loss and grad_norm, and the step-1 gradients."""
    from avsl_tpu_torch.train.loop import batch_to_device

    pair, cfg = _tiny_train_pair()
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        labels = rng.integers(0, 300, size=(2, 2, 9))
        labels[:, :, 6:] = -100
        batches.append({"input_ids": rng.normal(size=(2, 2, cfg.n_mels, 100)).astype(np.float32),
                        "dec_input_ids": rng.integers(0, 300, size=(2, 2, 9)), "labels": labels})
    grads = []
    for model, loss_fn, _, _ in pair:
        batch = batch_to_device(batches[0], model.device)
        for i in range(2):
            loss, _ = loss_fn({k: v[i] for k, v in batch.items()}, None)
            loss.backward()
        grads.append({n: p.grad.detach().cpu() / 2 for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    grad_err = max((grads[0][n] - g).abs().max().item() for n, g in grads[1].items())
    grad_ok = all(bool(((grads[0][n] - g).abs() <= SMALL_TRAIN_TOL["atol"]
                        + SMALL_TRAIN_TOL["rtol"] * g.abs()).all()) for n, g in grads[1].items())
    steps = []
    for batch in batches:
        got = []
        for _, _, state, step in pair:
            _, metrics = step(state, batch)
            got.append({k: float(v) for k, v in metrics.items()})
        steps.append({"card": got[0], "cpu": got[1]})
    rel = max(abs(s["card"][k] - s["cpu"][k]) / abs(s["cpu"][k])
              for s in steps for k in ("loss", "grad_norm"))
    log({"phase": "small_train_reference", "steps": steps, "step1_grad_max_abs_err": grad_err,
         "metric_max_rel_err": rel, "tolerance": SMALL_TRAIN_TOL})
    finite = all(math.isfinite(v) for s in steps for d in s.values() for v in d.values())
    if not finite or not grad_ok or rel > SMALL_TRAIN_TOL["rtol"]:
        raise AssertionError(f"tiny train step card-vs-cpu: grads {grad_err:.3e}, metrics {rel:.3e}")


def _word_transcript(rng, n_chars: int) -> str:
    words = ("meeting", "the", "remote", "control", "design", "button", "we", "should",
             "think", "about", "battery", "price", "user", "interface", "yeah", "okay",
             "project", "manager", "market", "research", "colour", "case", "speech")
    text = ""
    while len(text) < n_chars:
        text += ("" if not text else " ") + words[int(rng.integers(len(words)))]
    return text[:n_chars].strip()


def train_rows(n: int, seed: int = 0):
    """Synthetic training rows: 5-10 s of 16 kHz noise, transcripts of
    60-200 characters of meeting vocabulary."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        audio = (0.1 * rng.standard_normal(int(rng.integers(80000, 160001)))).astype(np.float32)
        rows.append({"audio": {"array": audio, "sampling_rate": 16000},
                     "transcript": _word_transcript(rng, int(rng.integers(60, 201)))})
    return rows


def prepare_train_path(steps: int):
    """The large-v2 audio-only training inputs as the port's whisper_ft
    composes them, from the training YAML: (cfg, tokenizer, collated train
    batches of batch_size x accumulation items, longest label)."""
    from avsl_tpu_torch.cli import whisper_ft
    from avsl_tpu_torch.core.config import FlamingoTrainConfig, WhisperConfig
    from avsl_tpu_torch.data.runtime import WhisperVideoCollator
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    cfg = FlamingoTrainConfig.from_yaml(TRAIN_CONFIG)
    cfg.add_gated_x_attn, cfg.use_av_hubert_encoder = 0, False
    tokenizer = get_tokenizer(cfg.download_root or None, cfg.lang)
    tokenizer.add_tokens(["<laugh>"])
    w_cfg = WhisperConfig.from_name(cfg.model_name)
    per_step = int(cfg.batch_size) * int(cfg.gradient_accumulation_steps)
    ds = whisper_ft.make_dataset(train_rows(per_step * steps), tokenizer, cfg, w_cfg)
    collator = WhisperVideoCollator(eot_id=tokenizer.eot, max_label_len=w_cfg.n_text_ctx)
    batches = list(whisper_ft.batches(ds, collator, per_step, True, 0))
    return cfg, tokenizer, batches, max(b["labels"].shape[1] for b in batches)


def phase_train_main_path(card: str, cfg, tokenizer, batches, out_dir: str):
    """Whisper large-v2 widths, audio-only, fp32 weights and Adam state
    under bf16 compute, trained as the port's whisper_ft composes it
    (flamingo_loss_fn with dropout and SpecAugment, whisper_optimizer,
    TrainerRunner's step): 3 optimizer steps of batch 1 x accumulation
    16, with the kernels' launches read around exactly those steps; then
    one step broken into forward, backward and optimizer (and checked for
    a nonzero gradient on every trained tensor) and one traced step.
    The runner's logs would go to ``out_dir``."""
    from avsl_tpu_torch.cli import whisper_ft
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn

    t0 = time.perf_counter()
    model, w_cfg = whisper_ft.build_model(cfg, tokenizer, "cuda", vocab_size=LARGE_V2_VOCAB)
    torch.cuda.synchronize()
    params = [p for p in model.parameters()]
    log({"phase": "build_train_model", "model": w_cfg.name, "n_vocab": w_cfg.n_vocab,
         "params": sum(p.numel() for p in params), "dtype": w_cfg.dtype,
         "param_dtype": w_cfg.param_dtype, "dropout": w_cfg.dropout_rate,
         "spec_augment": cfg.spec_augment, "learning_rate": cfg.learning_rate,
         "warmup_steps": cfg.warmup_steps, "batch_size": cfg.batch_size,
         "accumulation": cfg.gradient_accumulation_steps,
         "seconds": time.perf_counter() - t0})
    runner = whisper_ft.make_runner(cfg, model, tokenizer, out_dir)
    opt, accum = runner.state.optimizer, runner.accum
    reshaped = [runner.reshape_accum(b) for b in batches]
    n_steps = len(reshaped)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    before = [p.detach().clone() for p in params]
    records, unchanged_after_first = [], None
    fused_attention.launches = fused_attention_bwd.launches = 0
    for i, batch in enumerate(reshaped):
        lr = opt.learning_rate()
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.state, metrics = runner.train_step(runner.state, batch)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        records.append({"step": i + 1, "seconds": time.perf_counter() - t, "lr": lr,
                        "loss": loss, "grad_norm": grad_norm,
                        "label_tokens": int((batch["labels"] >= 0).sum()),
                        "label_len": int(batch["labels"].shape[-1])})
        if i == 0:
            unchanged_after_first = all(torch.equal(a, p) for a, p in zip(before, params))
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int((a != p).sum()) for a, p in zip(before, params))
    n_elems = sum(p.numel() for p in params)
    del before

    timed = records[1:] if n_steps > 1 else records
    sec = statistics.median(r["seconds"] for r in timed)
    tokens = statistics.median(r["label_tokens"] for r in timed)
    micro_steps = n_steps * accum
    per_micro = 3 * w_cfg.n_audio_layer  # encoder self, decoder self, cross
    log({"phase": "train_main_path", "card": card, "steps": records,
         "seconds_per_step_median_2_3": sec, "segments_per_s": accum * cfg.batch_size / sec,
         "label_tokens_per_s": tokens / sec, "max_memory_allocated_bytes": peak,
         "k1_launches": k1, "k2_launches": k2, "micro_steps": micro_steps,
         "expected_launches": per_micro * micro_steps,
         "params_unchanged_after_step_1": unchanged_after_first,
         "param_elements_changed_share": changed / n_elems})
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError("non-finite loss or grad_norm on the train path")
    if k1 != per_micro * micro_steps or k2 != per_micro * micro_steps:
        raise AssertionError(f"launches K1 {k1} / K2 {k2} != {per_micro * micro_steps}")
    if not unchanged_after_first:
        raise AssertionError("step 1 (learning rate 0) changed the parameters")
    if changed / n_elems < 0.5:
        raise AssertionError(f"only {changed / n_elems:.3f} of the parameters changed in 3 steps")

    # one more step, stage by stage (host clock, synchronised per stage)
    loss_fn = flamingo_loss_fn(model, train=True, spec_augment=cfg.spec_augment)
    gen = runner.state.generator
    batch = batch_to_device(reshaped[-1], model.device)
    stages = {"forward": 0.0, "backward": 0.0}
    for i in range(accum):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = loss_fn({k: v[i] for k, v in batch.items()}, gen)
        torch.cuda.synchronize()
        stages["forward"] += time.perf_counter() - t
        t = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        stages["backward"] += time.perf_counter() - t
    zero = [n for n, p in model.named_parameters() if p.grad is None or not bool(p.grad.any())]
    if zero:
        raise AssertionError(f"{len(zero)} trained tensors got no gradient, e.g. {zero[:4]}")
    t = time.perf_counter()
    grads = [p.grad for p in opt.params]
    torch._foreach_div_(grads, float(accum))
    opt.step(grads)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    stages["optimizer"] = time.perf_counter() - t
    log({"phase": "train_stage_breakdown", "card": card, "micro_steps": accum,
         "stage_seconds": stages, "trained_tensors_with_gradient": len(opt.params)})

    def one_step():
        runner.state, metrics = runner.train_step(runner.state, reshaped[0])
        float(metrics["loss"])

    log({"phase": "train_traced_step", "card": card, **traced_run(one_step)})
    return {"k1": k1, "k2": k2}


def traced_run(fn) -> dict:
    """Wall time of ``fn`` under torch.profiler, the summed duration of the
    device activity it traced, the idle share, and the five device
    kernels that took longest in total ("not measured" when the trace
    holds no device activity). Only device activity is recorded: host
    events would slow the host-bound loops they measure and take longer
    to collect than the run itself."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    t_collect = time.perf_counter()
    per_name: dict = {}
    # the raw kineto events: building prof.events() takes tens of seconds
    # for the 140k kernels of a train step
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            tot, n = per_name.get(e.name(), (0.0, 0))
            per_name[e.name()] = (tot + e.duration_ns() / 1e3, n + 1)
    collect = time.perf_counter() - t_collect
    if not per_name:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    busy = sum(tot for tot, _ in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": max(0.0, 1 - busy / wall),
            "trace_collect_s": collect,
            "device_launches": sum(n for _, n in per_name.values()),
            "top_kernels": [{"name": k[:90], "ms": v[0] / 1e3, "count": v[1]} for k, v in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          "TF32 off for matmul and cuDNN", flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from avsl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, together
        for future in [pool.submit(_build.load_library, name) for name in SOURCES]:
            future.result()
    log({"phase": "build", "sources": list(SOURCES), "seconds": time.perf_counter() - t0})
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    cfg, tokenizer, train_batches, label_len = prepare_train_path(TRAIN_STEPS)
    fwd_case = phase_kernels()[0]
    phase_kernel_stats()
    bwd_case = phase_kernels_bwd(label_len)[0]
    phase_small_reference()
    phase_cached_attention()
    phase_small_train_reference()
    serving_launches = phase_main_path(smi)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        train_launches = phase_train_main_path(smi, cfg, tokenizer, train_batches, out_dir)

    def entry(name, source, replaces, case, launches):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(launches.values()), "launches_by_path": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": case["library_ms"],
                "shape": case["shape"], "dtype": case["dtype"]}

    log({"kernels": [
        entry("flash_attention_fwd", "avsl_tpu_torch/csrc/flash_attn_fwd.cu",
              "avsl_tpu/kernels/attention.py:63", fwd_case,
              {"serving": serving_launches, "training": train_launches["k1"]}),
        entry("flash_attention_bwd", "avsl_tpu_torch/csrc/flash_attn_bwd.cu",
              "avsl_tpu/kernels/attention.py:159", bwd_case,
              {"serving": 0, "training": train_launches["k2"]}),
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
