"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with a CUDA card, ``nvcc`` and ``nvidia-smi``. Phases, each of which
raises on failure:

1. header: the card's name and power limit; TF32 off for the comparisons;
2. build: ``nvcc`` compiles the flash-attention kernel from
   ``avsl_tpu_torch/csrc``;
3. kernel against plain: the flash-attention kernel and its plain PyTorch
   version on the same tensors at the shapes of the serving path, with
   times (CUDA events, median of 20), the yardstick library call and the
   least time the card could take;
4. small reference: the tiny test model's teacher-forced logits on the
   card (through the kernel) against the same weights on the CPU (plain),
   and one bf16 cached cross-attention decode step (half-precision GEMMs
   with fp32 output) against the same step on upcast fp32 operands;
5. main path: Whisper large-v2 widths (bf16, seeded random weights,
   51865-token vocab) serving 16 synthetic 30 s windows through
   ``StreamingTranscriber`` at batch 8, with the kernel's launch count
   read around exactly that run, then a per-stage breakdown of one batch
   and a torch.profiler trace of its encoder and of 16 decode steps
   (device busy time, idle share, top kernels).

It prints the kernel list and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FP32_TOL = dict(atol=1e-4, rtol=0.0)


def log(obj) -> None:
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


def attention_bound(b, h, tq, tk, d, dtype, causal, lengths):
    """(bound_ms, bound_by, flops, bytes): the larger of the needed
    operations over the dtype's peak and each input read plus the output
    written once over the memory rate. Work counts the key pairs this
    data needs: k <= q under the causal mask, min(len, Tk) keys for a
    length, and for a length-0 row only the mean of V."""
    if causal:
        pairs_per_bh = sum(min(qi + 1, tk) for qi in range(tq))
        flops = 4 * b * h * pairs_per_bh * d
    elif lengths is not None:
        flops = sum(
            (4 * tq * min(n, tk) * d if n > 0 else 2 * tq * tk * d) * h
            for n in lengths
        )
    else:
        flops = 4 * b * h * tq * tk * d
    itemsize = torch.tensor([], dtype=dtype).element_size()
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

    fused_attention.launches = 0
    t0 = time.perf_counter()
    results = tr.transcribe(items)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_attention.launches

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
         "flash_attention_launches": launches,
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


def traced_run(fn) -> dict:
    """Wall time of ``fn`` under torch.profiler, the summed duration of the
    device activity it traced, the idle share, and the five device
    kernels that took longest in total ("not measured" when the trace
    holds no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    if not per_name:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    busy = sum(tot for tot, _ in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": max(0.0, 1 - busy / wall),
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

    from avsl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library("flash_attn_fwd")
    log({"phase": "build", "sources": ["flash_attn_fwd"], "seconds": time.perf_counter() - t0})
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    main_case = phase_kernels()[0]
    phase_small_reference()
    phase_cached_attention()
    launches = phase_main_path(smi)

    log({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "avsl_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "avsl_tpu/kernels/attention.py:63",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
