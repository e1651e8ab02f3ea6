"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: the port's
card gate. It measures no speed beyond the two kernels' device times; the
port's speed comes from the benchmark, ``portbench/``.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with a CUDA card, ``nvcc`` and ``nvidia-smi``. Phases, each of which
raises on failure:

1. header: the card's name and power limit; TF32 off for the comparisons;
2. build: ``nvcc`` compiles the flash-attention forward and backward
   kernels from ``avsl_tpu_torch/csrc``, one process per source, together;
   ``cuobjdump -sass`` then counts the tensor-core instructions in each
   library (``HGMMA`` from wgmma, ``HMMA`` from mma.sync) and the phase
   fails unless the forward has ``HGMMA`` and the backward either;
3. kernels against plain: the forward kernel (K1) and its plain PyTorch
   version at the shapes of the serving and the training path (the
   AV-HuBERT encoder's too, with and without key lengths, the gated video
   cross-attention's, the Flamingo training path's decoder and hoisted
   encoder, and the AV-HuBERT decoder's self-attention at D = 128, causal
   with key lengths, at the CLI's and an AMI batch's shapes); K1's row
   statistics against the plain row max and sum; the backward kernel (K2)
   against its plain version at the shapes of the training paths (and the
   serving encoder's); bf16 at D = 32 and 128 for both, and causal with
   key lengths at D = 64; each with its device time from torch.profiler
   beside the plain version's and the yardstick library call's, and the
   least time the card could take (:func:`attention_bound`, against
   ``portbench/peaks.json``);
4. small references: the tiny test model's teacher-forced logits on the
   card (through K1) against the same weights on the CPU (plain); the
   tiny Whisper-Flamingo model (its AV-HuBERT tower widened to 2 heads of
   32, which K1 takes; gates 0.5) the same way, with video, and through
   one cached decode step with the "xv" cache; one bf16 cached
   cross-attention decode step against upcast fp32 operands; and the tiny
   fp32 model trained 3 accumulated steps on the card (K1 + K2) against
   the CPU (per-step loss and grad norm, step-1 gradients); the tiny
   Whisper-Flamingo model (every dropout 0) trained the same way under the
   Flamingo regime with BatchNorm on batch statistics (also the running
   statistics after step 3), then with BatchNorm frozen, hoisted against
   in-scan; the tiny AV-HuBERT seq2seq and CTC models (encoder 2 heads of
   32, decoder 2 heads of 128, bf16 compute) the same way: logits with
   padded frames and both modalities, 3 train steps; then the staged lip
   frontend (``lip_frontend``) at the JAX transcriber's shape, 8 closeups
   x 250 frames x 288 x 352: on the card, then on the CPU (ok flags and
   mouth-window offsets equal, trajectories and crops within stated
   bounds), and ``extract_lip_clip`` card against CPU;
   and the serving options on the tiny Whisper-Flamingo model
   (``small_serving_reference``): the temperature fallback on the same
   injected noise, biased greedy and beam search, and the alignment
   pass's captured cross-attention weights and words, card against CPU;
5. serving path: Whisper large-v2 widths (bf16, seeded random weights,
   51865-token vocab) serving 16 synthetic 30 s windows through
   ``StreamingTranscriber`` at batch 8, with K1's launch count read around
   exactly that run (and no row statistics written);
6. audio-visual serving path (``av_main_path``): Whisper-Flamingo at full
   width, large-v2 plus the AV-HuBERT large video tower and gated
   cross-attention (bf16, seeded random weights, gates set to 0.5 as a
   trained model would have them), built as the JAX CLI's default config
   builds it, serving 16 synthetic 10 s windows (12 with 150-250 frames
   of seeded lip features, 4 audio-only) at the JAX CLI's serving shape
   (250 frames of 88 x 88, batch 8), with K1's launches read around
   exactly that run ((32 + 24) a batch, no row statistics, no K2), and a
   check that zeroing a batch's video moves its first-step logits;
7. training path: Whisper large-v2 widths, audio-only, fp32 weights and
   Adam state under bf16 compute, 51866-token vocab, the training YAML's
   settings (batch 1 x accumulation 16, 10 s windows, dropout 0.1, lr
   1e-5 with 1000 warmup steps; no SpecAugment, as ``whisper_ft``)
   composed as the port's ``whisper_ft`` composes them: 3 optimizer steps
   over 48 synthetic items with K1 and K2 launches read around exactly
   those steps, then one more step's gradients checked on every trained
   tensor;
8. Flamingo training path (``flamingo_train``, then
   ``flamingo_train_hoisted``): large-v2 plus AV-HuBERT large composed as
   the port's ``cli/finetune`` composes the training YAML (the Flamingo
   regime, SpecAugment, the tower's dropouts and LayerDrop, 250 seeded
   lip frames an item), towers in the loop with BatchNorm on batch
   statistics, then with BatchNorm frozen, which hoists the towers: 3
   steps each with the kernels' launches and the tower's forwards counted,
   frozen tensors unchanged, the same gradient check;
9. AV-HuBERT fine-tuning (``avhubert_cli``, ``avhubert_train``): the
   port's ``cli.avhubert_ft`` at full width (``configs/avhubert_large.yaml``:
   0.48 B parameters, concat fusion of 104-dim audio features and 88 x 88
   lip frames, 9 decoder layers of 8 heads of 128) for both heads, 3
   steps each, printing the CLI's JSON; then the seq2seq head on an AMI
   segment batch (8 items of 10 s: 250 frames of features made on the
   card by the port's ``avhubert_audio_features``, 250 lip frames, labels
   of 20-63 tokens): 3 steps with exactly 9 K1 and 9 K2 launches a step,
   one more step's gradients checked, the eval forward (24 + 9 K1), and the
   CTC head's train step (no kernel) and eval forward (24 K1);
10. the dataset path: ``resample`` (8 x 10 s at 44.1, 48 and 8 kHz to 16
   kHz on the card, against the CPU and float64 ``scipy.signal.upfirdn``
   with the same taps, within RESAMPLE_TOL),
   ``multisteps_small`` (the tiny Whisper-Flamingo model under
   ``MultiSteps``, accumulation 2 over micro-batches of 1-4 items, card
   against CPU after every micro-step), ``flamingo_dataset_train`` (the
   training YAML through ``cli.finetune.make_job`` and ``run``, what the
   CLI's ``main`` runs once ``load_datasets`` has read the splits, here on
   128 seeded rows held in memory, a quarter at 44.1 or 48 kHz, 4 val and
   4 test: 2 optimizer steps of 16 bucketed micro-batches, validation and
   ``test_best``, with exact K1/K2 launches a micro-step and an eval batch,
   frozen tensors bit-identical, trained tensors still between updates,
   every distinct K1 and K2 launch shape of the run against the plain
   version) and ``prefetch`` (bucketed batches through
   ``prefetch_to_device`` equal on the card; 2 optimizer steps with
   ``prefetch_batches`` 2);
11. the serving daemon (``serving_daemon``, on the model of phase 6,
   before it is freed): ``TranscriptionServer`` on 127.0.0.1 at batch 8,
   DAEMON_REQUESTS (8) concurrent 10 s requests (4 over HTTP as base64
   PCM, 4 with lip features through ``submit``) against the
   transcriber's ``transcribe``
   on the same items, a 60 s ``long`` request, a 15 s streaming session
   through the daemon, and the temperature fallback, word timestamps,
   phrase boosting and language ID on a batch each, with K1's launches
   gated around each, every reply held to 200 with no error or rejection,
   its request's id and the direct run's text, and every distinct K1
   launch shape of the phase against the plain version;
12. the serving extras (``serving_extras_*``): on the audio-only model
   of phase 5, speculative decoding (spec_k 4) with a random ``tiny``
   draft written by ``save_checkpoint`` and read back through the serving
   CLIs' ``--draft_ckpt`` path, and with the target as its own draft,
   against plain greedy on the same batch (K1 exactly 32 + 4 and 32 + 32
   a batch; greedy's tokens but at near-ties; the self draft accepting
   every token in 13 rounds but at near-tie rejections); then the
   audio-only large-v2 transcriber exported through ``cli/export_program
   --platforms cuda`` from a checkpoint and replayed with
   ``load_exported`` against the live transcriber (tokens equal, 32 K1 a
   batch by the launch counter and by the profiler's kernels); and on the
   AV model of phase 6, after the daemon, bf16, ``kv_int8``, int8 weights
   (bit-equal to the CPU's quantization of the same weights; the float
   model then freed) and both, each exactly 56 K1 a batch, with the tiny
   int8 model card against CPU;
13. the training extras: ``distill`` (after the export, ``cli.distill``'s
   ``main`` on a seeded audio-only large-v2 target saved to a checkpoint,
   the ``tiny`` draft, 32 seeded 10-30 s clips: the label pass and the
   steps with K1/K2 counted and every launch shape against the plain
   version, then ``serving_extras_speculative_distilled``: the distilled
   draft through the ``--draft_ckpt`` path against plain greedy on that
   target, greedy's tokens but at near-ties); after the dataset path,
   ``flamingo_lora_train`` (the training YAML through ``make_job`` and
   ``run`` with rank-8 adapters, EMA 0.999 and the YAML's remat: 2
   optimizer steps of PATH_ACCUM micro-batches, base tensors bit-identical, every
   B non-zero, ``best/`` the EMA, exact K1/K2 counts with the recompute,
   every launch shape against the plain version; ``cli.export_lora``, the
   merged model's logits within BF16_TOL, ``cli.transcribe --ckpt_dir``
   on 8 items) and ``remat_ab`` (that job, 2 steps of 2 micro-batches with
   remat off, ``block`` and ``dots``: launches and peak memory each);
14. evaluation and the reference's dataset layer: in phase 3, K1 and K2 at
   the tiny_test head dim 16 in fp32 and bf16 and fp32 at D = 128 (causal
   with key lengths and a length-0 row among them); after the daemon,
   ``preprocess_chain`` (a seeded NITE corpus of 2 meetings x 4 speakers x
   3 segments, one headset at 48 kHz, through the port's
   ``process_transcripts``, ``segment_sources`` and the sharded dataset
   round trip, on the host; the native media decode against ``load_wav``
   where ``cpp/avsl_media`` builds) and ``evaluate_main_path`` (``cli.
   evaluate``'s ``evaluate`` on the AV model of phase 6 with the flagship
   YAML at an eval batch of 8 over the chain's 24 segments with seeded lip
   frames: teacher-forced, then beam 4 with 64 new tokens, K1 exactly 152
   and 56 a batch, K2 never, every launch shape against the plain
   version); at the end ``evaluate_cli_smoke`` and
   ``avhubert_cli_smoke`` (``cli.evaluate --smoke --beam 2`` and
   ``cli.avhubert_ft --smoke`` on the card, whose tiny towers run K1 and
   K2 at head dim 16), each with exact K1/K2 counts;
15. span masks, MoE and pretraining: after the tiny AV-HuBERT reference,
   ``pretrain_small_reference`` (the tiny pretraining model card against
   CPU: logits, loss and gradients under one feature mask; a 4-expert
   top-2 MoE block's output and gradients; k-means on separated blobs);
   after ``avhubert_train``, ``pretrain_main_path`` (AV-HuBERT large on an
   AMI segment batch, k-means targets of 100 clusters on the card, 3
   steps of the masked-cluster loss with the CLI's optimizer (K1 0, K2 0:
   attention dropout 0.1 takes the unfused path), the eval loss (24 K1)
   and the relabel tap at layer 12 (12 K1) with every launch shape
   against the plain version, and 500-cluster k-means of the tapped
   features) and ``pretrain_moe`` (the same with 8 experts of top 2 in
   every block: 1.74 B parameters, the balance loss in (0, 8]); at the end
   ``pretrain_cli_smoke`` (``cli.pretrain --smoke``, with ``--n_experts 4
   --iterations 2``, and ``cli.avhubert_ft --smoke --n_experts 4`` for
   both heads), each with exact K1/K2 counts. The depth of the LoRA,
   dataset, remat and distillation phases was cut to make room (see
   LORA_STEPS, DATASET_STEPS, REMAT_AB_ACCUM, DISTILL_STEPS);
16. the AV-HuBERT tools, the landmark CNN and the preflight, last:
   ``avh_tools_main_path`` (``cli.extract``, default tap and ``--layer
   12``, and ``cli.align`` at full width on 8 seeded AMI-like 2-10 s rows
   without lip clips: K1 exactly 24, 12 and 24 a row at [1, 16, Tb, Tb,
   64] with no key lengths, every launch shape against the plain version,
   peak memory), ``avh_tools_card_vs_cpu``
   (the tiny card in fp32 through ``cli.extract`` and ``cli.align`` on the
   ``--smoke`` input, on the card against ``--device cpu`` from one
   checkpoint each), ``landmark_cnn``
   (``CNNLandmarkDetector`` on the shipped weights over JAX's 48 held-out
   faces, card against CPU and against the exact labels, then
   ``cli.train_landmarks`` 300 steps on 2,048 faces) and ``doctor``
   (``cli.doctor`` with and without ``--config``: rc 0, no FAIL, one K1
   launch each). To make room, the daemon's live stream was cut from 30 to
   STREAM_SECONDS and the dataset path's val and test rows from 8 to 4
   each (DATASET_ROWS, shared by the LoRA phase).
17. the mesh (``core/mesh.py``, ``core/partitioning.py``), after the
   Flamingo training phases: ``mesh_train_main_path`` (the flagship
   Whisper-Flamingo through ``cli.finetune.make_runner`` in a process
   group of one rank over NCCL, built four ways from one seeded state: no
   mesh, ``make_mesh(1)`` replicated, ZeRO-1 and FSDP, MESH_STEPS
   optimizer steps of MESH_ACCUM micro-batches each; losses, grad norms,
   trained tensors and BatchNorm statistics equal to the no-mesh runner's,
   K1/K2 counts equal, the FSDP checkpoint through ``restore_sharded`` into
   a replicated runner and back bit-equal; peak memory per variant) and
   ``mesh_cpu_ranks`` (the tiny model over 2 gloo ranks on the host CPU at
   dp 2 replicated, ZeRO-1, FSDP and dp 1 x mp 2 against one process, then
   ``cli.finetune --smoke --device cpu`` under ``torch.distributed.run``
   with ``num_devices: 2``).
   To make room, the Flamingo training phases' accumulation was cut from
   the YAML's 16 to PATH_ACCUM (8).
18. sequence parallelism and the serving mesh: ``mesh_serving_main_path``
   (right after the daemon, on its model: the flagship transcriber built
   through ``cli/_serving_common.py::build_transcriber`` on a mesh of one
   rank over NCCL, greedy and beam 2 over the AV main path's 16 items,
   tokens bit-equal to the no-mesh transcriber's, 56 K1 a batch);
   ``mesh_train_main_path``'s replicated variant steps with
   ``sequence_parallel=True`` (at a model axis of 1 it splits nothing) and
   every variant is held bit-equal to no mesh, FSDP included (at a data
   axis of 1 it is JAX's no-op); ``mesh_cpu_ranks`` runs dp 1 x mp 2 with
   sequence parallelism (train and eval steps, splits counted), the tiny
   transcriber at mp 2 and dp 2 against one process, and ``cli.transcribe
   --model_parallel 2`` under ``torch.distributed.run``. To make room:
   MESH_ACCUM 4 -> 2, LORA_ACCUM 8 -> 4, DISTILL_STEPS 50 -> 25,
   STREAM_SECONDS 15 -> 10.
19. expert parallelism: ``ep_avhubert_main_path`` (after ``pretrain_moe``:
   AV-HuBERT large with the seq2seq head and EP_EXPERTS experts of top
   EP_TOP_K through ``cli/avhubert_ft.py::train`` on a 1 x 1
   ``make_ep_mesh`` over NCCL and on no mesh, EP_STEPS steps each, every
   loss, balance loss, grad norm, the eval loss and every trained tensor
   bit-equal, K1 and K2 in every step; peak memory,
   ``moe_aux``, K1/K2 a step and ``sharded_params`` logged) and, in
   ``mesh_cpu_ranks``, the tiny MoE AV-HuBERT at (data 2, expert 1) with
   capacity binding and at (data 1, expert 2) against one process, and
   ``cli.pretrain --smoke --n_experts 4 --experts_parallel 2`` under
   ``torch.distributed.run``. To make room: LORA_ACCUM 4 -> 2.
20. pipeline parallelism: ``pp_whisper_main_path`` (after
   ``mesh_train_main_path``: large-v2's encoder at full width through
   ``train/pp.py::whisper_encoder_pp_forward`` on a 1 x 1 (data, stage)
   mesh over NCCL, PP_BATCH x 30 s in PP_MICRO microbatches bit-equal to
   the unpipelined blocks on the same row chunks and within BF16_TOL of
   the whole-batch encoder; the encoder with a pooled [1280, 51865] head
   trained PP_STEPS steps through ``shard_pp_state``, ``ClippedAdamW``
   and ``make_train_step`` against the unpipelined step, losses and step
   1's gradients within PP_LOSS_RTOL and PP_GRAD_REL_L2; the pp
   checkpoint read back into the unpipelined model; K1 and K2 counted and
   every launch shape against the plain version) and, in
   ``mesh_cpu_ranks``, the tiny encoder with its head pipelined over the
   2 gloo ranks as 2 stages, forward and 2 steps, against one process.
   To make room: the daemon's burst from 16 requests to DAEMON_REQUESTS
   (8), its new tokens from 64 to SERVE_MAX_NEW (32) and the int8 phase's
   from 64 to INT8_MAX_NEW (32).

Each model is freed before the next one is built. It prints the kernel
list, the card's name and power limit and, last,
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from avsl_tpu_torch.kernels.attention import (
    BF16_MAGNITUDE,
    BF16_TOL,
    BWD_FP32_TOL,
    FP32_TOL,
    STATS_TOL,
)
from portbench.launches import recorded

REPO = Path(__file__).resolve().parent
sys.path.append(str(REPO / "tests"))
from torch_attention_cases import (  # noqa: E402
    AMI_DEC_LENGTHS,
    D16_LENGTHS,
    D64_CAUSAL_LENGTHS,
    bwd_magnitudes,
)

SOURCES = ("flash_attn_fwd", "flash_attn_bwd")
# tiny fp32 train step, card (kernels) vs CPU (plain): sums over 2 x 2 items
# and 4 blocks in other orders, and K2 recomputes P from K1's online m, l
SMALL_TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
TRAIN_CONFIG = "configs/ami_whisper_flamingo_large.yaml"
LARGE_V2_VOCAB = 51865 + 1  # large-v2's vocab plus <laugh>
TRAIN_STEPS = 3
# the accumulation of the full-width Flamingo training phases (towers in
# the loop and hoisted, the dataset path and its prefetch, LoRA): the
# YAML's 16 until the mesh phases came, cut to make room for them
PATH_ACCUM = 8
# key lengths of the AV-HuBERT encoder case: full, partial, 1 and 0 frames
AV_LENGTHS = (250, 180, 1, 0, 250, 250, 97, 250)
# tiny Whisper-Flamingo on the card: AVHuBERTConfig.tiny_test widened to 2
# heads of 32 (the card-vs-CPU references predate K1's head dim 16, which is
# tiny_test's; the widths stay so their numbers stay comparable)
SMALL_AV_OVERRIDES = dict(hidden_size=64, intermediate_size=128)
SMALL_AV_TOL = 1e-3
GATE = 0.5
# the tiny tower with every training draw off, for card-vs-CPU training
ZERO_AV_RATES = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                     dropout_input=0.0, layerdrop=0.0, modality_dropout=0.0)
# tiny Flamingo train steps, card vs CPU: the tiny train tolerance, for the
# metrics, the step-1 gradients and the BatchNorm statistics after 3 steps
SMALL_FLAMINGO_TOL = SMALL_TRAIN_TOL
# lip frames of a 10 s window at 25 fps, as the dataset trims them
VIDEO_FRAMES = 250
AVHUBERT_CONFIG = "configs/avhubert_large.yaml"
# decoder key lengths (non-pad tokens) of the AV-HuBERT CLI's batch of 4
# (labels cut to 16); the AMI batch's are AMI_DEC_LENGTHS
CLI_DEC_LENGTHS = [16, 9, 1, 12]
# fp32 at D = 128, causal with key lengths: a length-0 row among them
D128_LENGTHS = [64, 0, 40, 17, 63, 2, 33, 64]
# tiny AV-HuBERT on the card: tiny_test widened to an encoder of 2 heads of
# 32 and a decoder of 2 heads of 128 (the bf16 tensor-core bodies' head
# dims), every rate 0, bf16 compute over fp32 weights on both sides
SMALL_AVH_OVERRIDES = dict(hidden_size=64, intermediate_size=128, decoder_hidden_size=256,
                           decoder_ffn_dim=512, decoder_attention_heads=2)
ZERO_AVH_RATES = dict(ZERO_AV_RATES, decoder_dropout=0.0, decoder_activation_dropout=0.0,
                      decoder_layerdrop=0.0)
# card (kernels) vs CPU (plain), both in bf16: elementwise on the logits;
# on the losses a relative bound; on the step-1 gradients the relative norm
# of the difference (all tensors together, and each decoder self-attention
# projection, where K1 and K2 run at D = 128); on the BatchNorm statistics
# an atol. bf16 against fp32 on the CPU differs by at most 0.025 on
# logits up to 9.7, 4e-4 on the losses and 3.4e-3 on the statistics.
SMALL_AVH_LOGITS_TOL = dict(atol=5e-2, rtol=2e-2)
SMALL_AVH_TRAIN_TOL = dict(loss_rtol=5e-3, grad_rel_norm=5e-2, stats_atol=1e-2)
# the AV-HuBERT training run's batch: an AMI segment batch
AVH_BATCH, AVH_SAMPLES, AVH_LABELS, AVH_MAX_LABEL = 8, 160000, (20, 63), 64
# the lip frontend at the JAX transcriber's shape: 8 closeups of 250 frames
# at raw_video_hw 288 x 352; card against CPU: trajectories (float32 sums of
# up to 250 mouth positions near 200 px in another order, where an ulp is
# 4e-3) within LIP_TRAJ_TOL px; the tracked ones within LIP_TRACK_TOL (an
# NCC argmax near-tie moves one frame by detect_ds = 2 px before the
# 12-frame smoothing); the sampler on equal coordinates within
# LIP_SAMPLE_TOL grey levels (fp32 products of exact bilinear weights); the
# sampling coordinates within LIP_COORD_TOL px, and so the whole chain's
# crops within LIP_CROP_TOL grey levels (a tap moves at most 255 a pixel on
# each of the two axes)
LIP_SHAPE = (8, 250, 288, 352)
LIP_ROI = 144
LIP_TRAJ_TOL = 0.05
LIP_TRACK_TOL = 0.5
LIP_SAMPLE_TOL = 1e-2
LIP_COORD_TOL = 1e-2
LIP_CROP_TOL = 2 * 255 * LIP_COORD_TOL + LIP_SAMPLE_TOL


T_START = time.perf_counter()


def log(obj) -> None:
    """Print a dict as one JSON line, stamped with the script's elapsed
    seconds, or anything else as it is."""
    if isinstance(obj, dict):
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def device_ms(fn, reps: int = 10):
    """Device time of ``fn`` in ms: the summed duration of the device work
    it launched (torch.profiler, device activity only) over ``reps``
    calls, after one warm-up call; "not measured" when the trace holds no
    device activity. It leaves out the host time between launches, which
    dominates small shapes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back empty; take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
        if total:
            return total / reps / 1e6
    return "not measured"


def timings(kernel, plain, library) -> dict:
    """Device times of the kernel, its plain version and the library call."""
    return {f"{key}_device_ms": device_ms(fn)
            for key, fn in (("kernel", kernel), ("plain", plain), ("library", library))}


def attention_bound(b, h, tq, tk, d, dtype, causal, lengths, backward=False):
    """(bound_ms, bound_by, flops, bytes): the larger of the needed
    operations over the dtype's peak and each input read plus each output
    written once over the memory rate, both from ``portbench/peaks.json``.

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
    with open(REPO / "portbench" / "peaks.json") as f:
        peaks = json.load(f)["NVIDIA H100"]
    peak = peaks["bf16_flops"] if dtype == torch.bfloat16 else peaks["fp32_flops"]
    t_ops, t_mem = flops / peak, nbytes / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def check_attention_case(name, b, h, tq, tk, d, dtype, causal=False, lengths=None, seed=0,
                         timed=True):
    """The forward kernel against its plain version on the same tensors;
    with ``timed``, also its device time beside the plain version's, the
    library's and the bound, logged. Returns the record."""
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
    rec = {
        "case": name, "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "D": d},
        "dtype": str(dtype).replace("torch.", ""), "causal": causal, "lengths": lengths,
        "max_abs_err": err.max().item(), "tolerance": tol,
    }
    if not timed:
        return rec
    bound_ms, bound_by, flops, nbytes = attention_bound(b, h, tq, tk, d, dtype, causal, lengths)
    rec.update(**timings(kernel, plain, library), bound_ms=bound_ms, bound_by=bound_by,
               flops=flops, bytes=nbytes)
    if isinstance(rec["kernel_device_ms"], float):
        rec["kernel_device_tflops"] = flops / rec["kernel_device_ms"] / 1e9
    log(rec)
    return rec


def phase_kernels(label_len: int, flamingo_len: int):
    """K1 against its plain version at the serving path's shapes, at the
    training path's (``label_len`` is the longest decoder sequence of the
    train path), at the bf16 tensor-core body's second head dim, at the
    audio-visual path's: the AV-HuBERT encoder's self-attention (with
    and without key lengths, a length-0 row included), the gated video
    cross-attention of a teacher-forced 70-token decoder, and the Whisper
    encoder at the AV path's 10 s windows; and at the Flamingo training
    path's (``flamingo_len`` its pinned label length): the gated x_attn
    onto 250 video frames, the decoder's self- and cross-attention, and
    the hoisted Whisper encoder over a step's 16 items; and the
    speculative draft's (the tiny preset's encoder, 6 heads)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        check_attention_case("a_encoder_bf16", 8, 20, 1500, 1500, 64, bf16),
        check_attention_case("a_encoder_fp32", 8, 20, 1500, 1500, 64, f32),
        check_attention_case("b_decoder_self_causal", 8, 20, 448, 448, 64, bf16, causal=True),
        check_attention_case("c_cross", 8, 20, 70, 1500, 64, bf16),
        check_attention_case("d_ragged_lengths", 4, 20, 1003, 1003, 64, bf16,
                             lengths=[0, 1003, 517, 1]),
        check_attention_case("e_tiny_head_dim", 8, 2, 200, 200, 32, f32),
        check_attention_case("f_train_encoder_bf16", 1, 20, 500, 500, 64, bf16),
        check_attention_case("g_train_decoder_self_causal", 1, 20, label_len, label_len, 64, bf16,
                             causal=True),
        check_attention_case("h_train_cross", 1, 20, label_len, 500, 64, bf16),
        check_attention_case("i_tiny_head_dim_bf16", 8, 2, 200, 200, 32, bf16),
        check_attention_case("j_avhubert_encoder_bf16", 8, 16, 250, 250, 64, bf16),
        check_attention_case("k_avhubert_lengths", 8, 16, 250, 250, 64, bf16,
                             lengths=list(AV_LENGTHS)),
        check_attention_case("l_x_attn_cross", 8, 20, 70, 250, 64, bf16),
        check_attention_case("m_av_whisper_encoder_bf16", 8, 20, 500, 500, 64, bf16),
        check_attention_case("n_flamingo_x_attn", 1, 20, flamingo_len, VIDEO_FRAMES, 64, bf16),
        check_attention_case("o_flamingo_decoder_self_causal", 1, 20, flamingo_len, flamingo_len,
                             64, bf16, causal=True),
        check_attention_case("p_flamingo_cross", 1, 20, flamingo_len, 500, 64, bf16),
        check_attention_case("q_hoisted_whisper_encoder", PATH_ACCUM, 20, 500, 500, 64, bf16),
        check_attention_case("r_avhubert_decoder_self_cli", 4, 8, 16, 16, 128, bf16, causal=True,
                             lengths=CLI_DEC_LENGTHS),
        check_attention_case("s_avhubert_decoder_self_ami", 8, 8, 64, 64, 128, bf16, causal=True,
                             lengths=AMI_DEC_LENGTHS),
        check_attention_case("t_head_dim_128", 8, 8, 250, 250, 128, bf16),
        check_attention_case("u_causal_lengths_d64", 8, 16, 100, 100, 64, bf16, causal=True,
                             lengths=D64_CAUSAL_LENGTHS),
        check_attention_case("v_tiny_draft_encoder", 8, 6, 1500, 1500, 64, bf16),
        check_attention_case("w_head_dim_16_fp32", 8, 2, 200, 200, 16, f32),
        check_attention_case("x_head_dim_16_bf16", 8, 2, 200, 200, 16, bf16),
        check_attention_case("y_head_dim_16_causal_lengths_fp32", 4, 2, 100, 100, 16, f32,
                             causal=True, lengths=D16_LENGTHS),
        check_attention_case("z_head_dim_16_causal_lengths_bf16", 4, 2, 100, 100, 16, bf16,
                             causal=True, lengths=D16_LENGTHS),
        check_attention_case("za_head_dim_128_fp32", 8, 8, 250, 250, 128, f32),
        check_attention_case("zb_head_dim_128_causal_lengths_fp32", 8, 8, 64, 64, 128, f32,
                             causal=True, lengths=D128_LENGTHS),
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


def check_attention_bwd_case(name, b, h, tq, tk, d, dtype, causal=False, lengths=None, seed=0,
                             magnitude=False, timed=True):
    """The backward kernel against its plain version on the same tensors
    (dQ, dK, dV); with ``timed``, also device times, the backward of
    scaled_dot_product_attention as the yardstick, and the bound, logged.
    With ``magnitude`` the bf16 limit adds ``BF16_MAGNITUDE`` times each
    element's magnitude sum (:func:`bwd_magnitudes`). Returns the record."""
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

    def library():
        return torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else BWD_FP32_TOL
    magnitude = magnitude and dtype == torch.bfloat16
    mags = bwd_magnitudes(q, k, v, o, g, lens, causal) if magnitude else [0.0] * 3
    rec = {"phase": "k2_against_plain", "case": name,
           "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "D": d},
           "dtype": str(dtype).replace("torch.", ""), "causal": causal, "lengths": lengths,
           "tolerance": dict(tol, magnitude=BF16_MAGNITUDE if magnitude else 0.0)}
    worst = 0.0
    for key, x, w, mag in zip(("dq", "dk", "dv"), got, want, mags):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name}: kernel {key} is not finite")
        err = (x.float() - w.float()).abs()
        rec[f"{key}_max_abs_err"] = err.max().item()
        worst = max(worst, rec[f"{key}_max_abs_err"])
        limit = tol["atol"] + tol["rtol"] * w.float().abs() + BF16_MAGNITUDE * mag
        if magnitude:  # the share of the limit the worst element uses
            rec[f"{key}_max_err_over_limit"] = (err / limit).max().item()
        if not bool((err <= limit).all()):
            raise AssertionError(f"{name}: kernel {key} vs plain max_abs_err "
                                 f"{rec[f'{key}_max_abs_err']:.3e} over {rec['tolerance']}")
    rec["max_abs_err"] = worst
    if not timed:
        return rec
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = None
    if lens is not None:
        mask = (torch.arange(tk, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=causal)
    gh = g.transpose(1, 2)
    bound_ms, bound_by, flops, nbytes = attention_bound(
        b, h, tq, tk, d, dtype, causal, lengths, backward=True)
    rec.update({**timings(kernel, plain, library),
                "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes})
    if isinstance(rec["kernel_device_ms"], float):
        rec["kernel_device_tflops"] = flops / rec["kernel_device_ms"] / 1e9
    log(rec)
    return rec


def phase_kernel_stats(flamingo_len: int):
    bf16 = torch.bfloat16
    check_attention_stats("train_encoder", 1, 20, 500, 500, 64, bf16)
    check_attention_stats("decoder_self_causal", 1, 20, 210, 210, 64, bf16, causal=True)
    check_attention_stats("ragged_lengths", 4, 20, 1003, 1003, 64, bf16, lengths=[0, 1003, 517, 1])
    check_attention_stats("flamingo_x_attn", 1, 20, flamingo_len, VIDEO_FRAMES, 64, bf16)
    check_attention_stats("avhubert_decoder_self_ami", 8, 8, 64, 64, 128, bf16, causal=True,
                          lengths=AMI_DEC_LENGTHS)
    check_attention_stats("head_dim_16_causal_lengths", 4, 2, 100, 100, 16, bf16, causal=True,
                          lengths=D16_LENGTHS)
    check_attention_stats("head_dim_128_fp32_causal_lengths", 8, 8, 64, 64, 128, torch.float32,
                          causal=True, lengths=D128_LENGTHS)


def phase_kernels_bwd(label_len: int, flamingo_len: int):
    """K2 against its plain version at the training path's shapes
    (``label_len`` is the longest decoder sequence of the train path), at
    the serving encoder shape, and at the Flamingo training path's
    (``flamingo_len`` its pinned label length: the gated x_attn, the
    decoder's self- and cross-attention; and x_attn at the teacher-forced
    serving shape), beside K1's row."""
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
        check_attention_bwd_case("g_tiny_head_dim_bf16", 8, 2, 200, 200, 32, bf16),
        check_attention_bwd_case("h_x_attn_teacher_forced", 8, 20, 70, VIDEO_FRAMES, 64, bf16),
        check_attention_bwd_case("i_flamingo_x_attn", 1, 20, flamingo_len, VIDEO_FRAMES, 64, bf16),
        check_attention_bwd_case("j_flamingo_decoder_self_causal", 1, 20, flamingo_len,
                                 flamingo_len, 64, bf16, causal=True),
        check_attention_bwd_case("k_flamingo_cross", 1, 20, flamingo_len, 500, 64, bf16),
        check_attention_bwd_case("l_avhubert_decoder_self_cli", 4, 8, 16, 16, 128, bf16,
                                 causal=True, lengths=CLI_DEC_LENGTHS, magnitude=True),
        check_attention_bwd_case("m_avhubert_decoder_self_ami", 8, 8, 64, 64, 128, bf16,
                                 causal=True, lengths=AMI_DEC_LENGTHS, magnitude=True),
        check_attention_bwd_case("n_head_dim_128", 8, 8, 250, 250, 128, bf16, magnitude=True),
        check_attention_bwd_case("o_causal_lengths_d64", 8, 16, 100, 100, 64, bf16, causal=True,
                                 lengths=D64_CAUSAL_LENGTHS, magnitude=True),
        check_attention_bwd_case("p_head_dim_16_fp32", 8, 2, 200, 200, 16, f32),
        check_attention_bwd_case("q_head_dim_16_bf16", 8, 2, 200, 200, 16, bf16),
        check_attention_bwd_case("r_head_dim_16_causal_lengths_fp32", 4, 2, 100, 100, 16, f32,
                                 causal=True, lengths=D16_LENGTHS),
        check_attention_bwd_case("s_head_dim_16_causal_lengths_bf16", 4, 2, 100, 100, 16, bf16,
                                 causal=True, lengths=D16_LENGTHS, magnitude=True),
        check_attention_bwd_case("t_head_dim_128_fp32", 8, 8, 250, 250, 128, f32),
        check_attention_bwd_case("u_head_dim_128_causal_lengths_fp32", 8, 8, 64, 64, 128, f32,
                                 causal=True, lengths=D128_LENGTHS),
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


def set_gates(model, value: float) -> None:
    """Every gated block's x_attn and x_mlp gate to ``value``: zero (their
    initial value) would hide the video from the logits."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("x_attn_gate", "x_mlp_gate")):
                p.fill_(value)


def phase_small_av_reference():
    """Tiny Whisper-Flamingo (fp32, the AV-HuBERT tower at 2 heads of 32,
    gates 0.5): teacher-forced logits with video on the card (K1 in the
    tower, the encoder, the decoder and the gated x_attn; cuDNN in the
    ResNet) against the CPU (plain), then a prompt and one cached decode
    step through the "xv" cache."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.kernels.attention import fused_attention
    from avsl_tpu_torch.models import build_whisper_flamingo

    av_cfg = AVHuBERTConfig.tiny_test(dtype="float32", **SMALL_AV_OVERRIDES)
    models = []
    for device in ("cpu", "cuda"):
        model, cfg = build_whisper_flamingo("test", vocab_size=300, add_gated_x_attn=1,
                                            av_hubert_cfg=av_cfg, dtype="float32",
                                            device=device, seed=3)
        set_gates(model, GATE)
        if models:
            model.load_state_dict(models[0].state_dict())
        models.append(model)
    rng = np.random.default_rng(6)
    mel = torch.from_numpy(rng.normal(size=(2, cfg.n_mels, 100)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 300, size=(2, 7)))
    video = torch.from_numpy(rng.normal(size=(2, 10, 88, 88, 1)).astype(np.float32))
    outs = []
    with torch.inference_mode():
        for model in models:
            dev = model.device
            fused_attention.launches = 0
            logits = model(mel.to(dev), toks.to(dev), video.to(dev))
            k1_forward = fused_attention.launches
            feats, xv = model.encode(mel.to(dev), video.to(dev))
            cache = model.init_decode_cache(feats, xv, 12)
            step0, cache = model.decode(toks[:, :6].to(dev), None, None, cache)
            step1, _ = model.decode(toks[:, 6:7].to(dev), None, None, cache)
            outs.append([t.float().cpu() for t in (logits, step0, step1)])
    with torch.inference_mode():
        zero_video = models[0](mel, toks, torch.zeros_like(video))
    errs = [(g - w).abs().max().item() for g, w in zip(outs[1], outs[0])]
    moved = (outs[0][0] - zero_video).abs().max().item()
    log({"phase": "small_av_reference", "av_hidden": av_cfg.hidden_size,
         "av_heads": av_cfg.num_attention_heads, "logits_max_abs_err": errs[0],
         "cached_decode_max_abs_err": errs[1:], "video_moves_logits_by": moved,
         "k1_launches_forward": k1_forward, "atol": SMALL_AV_TOL})
    finite = all(bool(torch.isfinite(t).all()) for t in outs[1])
    if not finite or max(errs) > SMALL_AV_TOL:
        raise AssertionError(f"tiny AV model card-vs-cpu differs by {max(errs):.3e}")
    if moved < 1e-3:
        raise AssertionError(f"the video moved the tiny AV logits by only {moved:.3e}")
    # teacher-forced card forward: tower 2, encoder 2, decoder self 2, x_attn 2, cross 2
    if k1_forward != 10:
        raise AssertionError(f"the tiny AV forward launched K1 {k1_forward} times, not 10")


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
         "max_abs_err": err.max().item(), "tolerance": BF16_TOL})
    if not torch.isfinite(got.float()).all() or not bool((err <= limit).all()):
        raise AssertionError(f"cached attention differs from upcast by {err.max().item():.3e}")


def run_counted(fn):
    """``fn()`` with K1 and K2 launches counted from 0 around exactly that
    call and the K1 launches that wrote row statistics counted: ``(result,
    k1 launches, row-statistics writes, k2 launches)``."""
    from avsl_tpu_torch.kernels import attention

    stats_writes = []
    unwrapped = attention.flash_attention_fwd_cuda

    def counting(*args, **kw):  # records which K1 launches write row statistics
        stats_writes.append(bool(kw.get("stats", False)))
        return unwrapped(*args, **kw)

    attention.flash_attention_fwd_cuda = counting
    attention.fused_attention.launches = attention.fused_attention_bwd.launches = 0
    try:
        result = fn()
    finally:
        attention.flash_attention_fwd_cuda = unwrapped
    return (result, attention.fused_attention.launches, sum(stats_writes),
            attention.fused_attention_bwd.launches)


def check_launch_shapes(launches: list) -> dict:
    """Hold K1 and K2 against their plain versions at every distinct
    launch signature ``(kind, B, H, Tq, Tk, D, dtype, causal, has
    lengths)`` among ``launches`` (as ``portbench/launches.py::recorded``
    writes them), on seeded inputs of that shape and with the key lengths
    of its first launch, within the timed cases' tolerances (the
    magnitude term where those use it: causal with key lengths, or D =
    128). The shapes are the ones a run gave the kernels, every bucket and
    micro-batch size included. Returns, per kernel, the count of shapes,
    the worst error, and the batch sizes and query and key lengths they
    span."""
    seen = {}
    for rec in launches:
        dtype = torch.bfloat16 if rec["itemsize"] == 2 else torch.float32
        key = (rec["kind"], rec["b"], rec["h"], rec["tq"], rec["tk"], rec["d"], dtype,
               rec["causal"], rec["lengths"] is not None)
        seen.setdefault(key, rec["lengths"])
    out = {}
    for kind, check in (("fwd", check_attention_case), ("bwd", check_attention_bwd_case)):
        keys = sorted((k for k in seen if k[0] == kind), key=str)
        worst, shapes = 0.0, []
        for key in keys:
            _, b, h, tq, tk, d, dtype, causal, has_len = key
            extra = {"magnitude": (causal and has_len) or d == 128} if kind == "bwd" else {}
            rec = check(f"path_{kind}_{b}x{h}x{tq}x{tk}x{d}", b, h, tq, tk, d, dtype,
                        causal=causal, lengths=seen[key], timed=False, **extra)
            worst = max(worst, rec["max_abs_err"])
            shapes.append([b, h, tq, tk, d, str(dtype).replace("torch.", ""), causal, has_len])
        out[kind] = {"shapes": len(keys), "max_abs_err": worst,
                     "batch_sizes": sorted({s[0] for s in shapes}),
                     "query_lengths": sorted({s[2] for s in shapes}),
                     "key_lengths": sorted({s[3] for s in shapes}), "all": shapes}
    return out


def check_served(results, n_items: int, max_new: int) -> None:
    if len(results) != n_items:
        raise AssertionError(f"{len(results)} results for {n_items} items")
    if not all(math.isfinite(r.avg_logprob) for r in results):
        raise AssertionError("non-finite avg_logprob")
    if any(len(r.tokens) != max_new for r in results):
        raise AssertionError("token rows of the wrong length")


def decoded_tokens(results, eot: int, max_new: int) -> int:
    return sum(next((i + 1 for i, t in enumerate(r.tokens) if t == eot), max_new)
               for r in results)


def phase_main_path(card: str):
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.models import build_whisper_flamingo

    model, cfg = build_whisper_flamingo(
        "large-v2", add_gated_x_attn=0, use_av_hubert_encoder=False,
        dtype="bfloat16", device="cuda", seed=0,
    )
    n_params = sum(p.numel() for p in model.parameters())
    log({"phase": "build_model", "model": cfg.name, "params": n_params, "n_vocab": cfg.n_vocab})
    batch, n_items, max_new = 8, 16, 64
    tr = StreamingTranscriber(model, ByteTokenizer(), audio_max_length=480000,
                              batch_size=batch, max_new_tokens=max_new)
    rng = np.random.default_rng(0)
    items = [
        {"id": f"seg{i:02d}",
         "audio": (0.1 * rng.standard_normal(int(rng.integers(320000, 480001)))).astype(np.float32)}
        for i in range(n_items)
    ]
    torch.cuda.reset_peak_memory_stats()

    results, launches, stats_writes, k2 = run_counted(lambda: tr.transcribe(items))
    if stats_writes or k2:
        raise AssertionError("the serving path wrote row statistics or ran the backward kernel")
    n_batches = math.ceil(n_items / batch)
    check_served(results, n_items, max_new)
    if launches != cfg.n_audio_layer * n_batches:
        raise AssertionError(f"flash-attention launches {launches} != {cfg.n_audio_layer * n_batches}")
    log({"phase": "main_path", "card": card, "items": n_items, "batches": n_batches,
         "decode_tokens": decoded_tokens(results, tr.tokenizer.eot, max_new),
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "flash_attention_launches": launches, "row_statistics_written": stats_writes,
         "avg_logprob_first": results[0].avg_logprob})
    return launches, model


def av_items(n_items: int, seed: int = 1):
    """Synthetic AV serving items: 7.5-10 s of 16 kHz noise each; three of
    every four carry 150-250 frames of seeded lip features (normalised
    noise, 88 x 88), the fourth is audio-only."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_items):
        item = {"id": f"av{i:02d}",
                "audio": (0.1 * rng.standard_normal(int(rng.integers(120000, 160001)))).astype(np.float32)}
        if i % 4 != 3:
            n_frames = int(rng.integers(150, 251))
            item["lip_feats"] = rng.standard_normal((n_frames, 88, 88, 1), dtype=np.float32)
        items.append(item)
    return items


def phase_av_main_path(card: str):
    """Whisper-Flamingo serving at full width (see the module docstring,
    phase 6): the model the JAX CLI builds by default, served through the
    port's StreamingTranscriber at the JAX CLI's serving shape. Returns the
    K1 launches, (model, config) for the raw-closeup phase and the
    phase's record."""
    from avsl_tpu_torch.cli._serving_common import serving_video_frames
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
    from avsl_tpu_torch.models import build_whisper_flamingo

    serve_cfg = FlamingoTrainConfig()  # the JAX CLI's default: the AV model, 10 s windows
    model, cfg = build_whisper_flamingo(
        serve_cfg.model_name, add_gated_x_attn=serve_cfg.add_gated_x_attn,
        use_av_hubert_encoder=serve_cfg.use_av_hubert_encoder,
        dtype="bfloat16", device="cuda", seed=0,
    )
    set_gates(model, GATE)
    av_cfg = model.video_model.cfg
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    log({"phase": "build_av_model", "model": cfg.name, "params": count(model),
         "video_tower_params": count(model.video_model), "n_vocab": cfg.n_vocab,
         "av_hubert": {"hidden": av_cfg.hidden_size, "layers": av_cfg.num_hidden_layers,
                       "heads": av_cfg.num_attention_heads, "ffn": av_cfg.intermediate_size},
         "gates": GATE})
    batch, n_items, max_new = 8, 16, 64
    audio_max_length = int(serve_cfg.audio_max_length)
    video_frames = serving_video_frames(audio_max_length)
    tr = StreamingTranscriber(model, ByteTokenizer(), audio_max_length=audio_max_length,
                              video_frames=video_frames, crop=88, batch_size=batch,
                              max_new_tokens=max_new)
    items = av_items(n_items)
    torch.cuda.reset_peak_memory_stats()

    results, launches, stats_writes, k2 = run_counted(lambda: tr.transcribe(items))
    if stats_writes or k2:
        raise AssertionError("the AV serving path wrote row statistics or ran the backward kernel")
    n_batches = math.ceil(n_items / batch)
    check_served(results, n_items, max_new)
    per_batch = cfg.n_audio_layer + av_cfg.num_hidden_layers
    if launches != per_batch * n_batches:
        raise AssertionError(f"flash-attention launches {launches} != {per_batch * n_batches}")
    with_video = [r.id for r in results if r.has_video]
    if with_video != [it["id"] for it in items if "lip_feats" in it] or len(with_video) != 12:
        raise AssertionError(f"has_video on {with_video}")
    record = {"phase": "av_main_path", "card": card, "items": n_items, "batches": n_batches,
              "items_with_video": len(with_video), "video_frames": video_frames,
              "audio_max_length": audio_max_length,
              "decode_tokens": decoded_tokens(results, tr.tokenizer.eot, max_new),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "flash_attention_launches": launches, "row_statistics_written": stats_writes,
              "backward_launches": k2, "avg_logprob_first": results[0].avg_logprob}
    log(record)
    # the mesh transcriber's reference (phase_mesh_serving_main_path), not logged
    record["tokens"] = [list(r.tokens) for r in results]

    # the gates carry the video: a batch's first-step logits move when its
    # video is zeroed (rows with video), and only there
    prep = tr._prepare_batch(items[:batch])
    prompt = tr._prompt
    with torch.inference_mode():
        mel = log_mel_spectrogram(torch.from_numpy(prep.audio).cuda(), n_mels=cfg.n_mels)
        vid = torch.from_numpy(prep.video).cuda()

        def first_logits(v):
            feats, xv = model.encode(mel, v)
            logits, _ = model.decode(prompt, None, None,
                                     model.init_decode_cache(feats, xv, prompt.shape[1] + 2))
            return logits[:, -1].float()

        moved = (first_logits(vid) - first_logits(torch.zeros_like(vid))).abs().amax(dim=-1)
    moved = moved.cpu().tolist()
    video_rows = [m for m, f in zip(moved, prep.flags) if f]
    log({"phase": "av_gate_check", "first_step_logit_change_by_row": moved,
         "rows_with_video": prep.flags})
    if min(video_rows) < 1e-3:
        raise AssertionError(f"zeroing the video left rows' first-step logits unchanged: {moved}")
    return launches, (model, serve_cfg), record


def closeup_clips(b: int, t: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """Synthetic raw closeups, uint8 [b, t, h, w] made on ``device``: the
    moving-blob closeups with a flickering mouth of
    tests/test_lip_pipeline.py:36-54, as tests/torch_lip_fixtures.py
    builds them for the detector to find (a textured head moving over a
    static background, sideways by 5 % of the width and up and down by 2 %
    of the height, its mouth 0.14 h below the centre darkening every other
    frame), sizes scaled to the frame."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.integers(40, 200, (h, w)).astype(np.float32)).to(device)
    tex = torch.from_numpy(rng.integers(0, 90, (h, w)).astype(np.float32)).to(device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    ti = torch.arange(t, dtype=torch.float32, device=device)
    out = torch.empty((b, t, h, w), dtype=torch.uint8, device=device)
    for bi in range(b):
        cx, cy = w / 2 + 0.03 * w * (bi % 3 - 1), h / 2
        jx = 0.05 * w * torch.sin(ti / 7 + bi)
        jy = 0.02 * h * torch.sin(ti / 11 + bi)
        ex, ey = (xx - cx - jx[:, None, None]), (yy - cy - jy[:, None, None])
        env = torch.exp(-(((ex / (0.17 * w)) ** 2 + (ey / (0.28 * h)) ** 2) ** 2))
        rows = (torch.arange(h, device=device)[None] - jy.round().long()[:, None]) % h
        cols = (torch.arange(w, device=device)[None] - jx.round().long()[:, None]) % w
        head = 90 + tex[rows[:, :, None], cols[:, None, :]]  # the texture rolled with the head
        flicker = (torch.arange(t, device=device) % 2).float()[:, None, None]
        mouth = 70 * flicker * torch.exp(-((ex / (0.05 * w)) ** 2 + ((ey - 0.14 * h) / (0.035 * h)) ** 2))
        out[bi] = (base * (1 - env) + head * env - mouth).clamp(0, 255).to(torch.uint8)
    return out


def phase_lip_frontend(card: str, device: str = "cuda", shape=LIP_SHAPE):
    """The staged lip frontend at the JAX transcriber's shape (``shape``: 8
    clips x 250 frames of 288 x 352, ``detect_ds`` 2, window 25) on the card,
    then the same functions on the CPU:
    ok flags and int32 mouth-window offsets equal, trajectories within
    ``LIP_TRAJ_TOL`` px (tracked: ``LIP_TRACK_TOL``), the sampler on the
    same coordinates within ``LIP_SAMPLE_TOL`` grey levels, the sampling
    coordinates within ``LIP_COORD_TOL`` px and the whole chain's crops
    within ``LIP_CROP_TOL`` grey levels; every closeup detected; then
    ``extract_lip_clip`` on one clip with MotionEnergyDetector landmarks,
    card against CPU: crop-window centres equal, uint8 crops within 1 grey
    level."""
    from avsl_tpu_torch.data.landmarks import MotionEnergyDetector
    from avsl_tpu_torch.data.lip_roi import (
        canonical_mean_face,
        extract_lip_clip,
        landmarks_interpolate,
        smooth_landmarks,
    )
    from avsl_tpu_torch.kernels.lip_pipeline import make_staged_lip_frontend
    from avsl_tpu_torch.kernels.warp import _crop_window_coeffs, STABLE_IDX

    b, t, h, w = shape
    torch.cuda.reset_peak_memory_stats()
    clips = closeup_clips(b, t, h, w, seed=11, device=device)
    st = make_staged_lip_frontend(t, window=25, detect_ds=2)

    def chain(x):
        small = st["subsample"](x)
        traj = st["traj"](small)
        tracked = st["track_refine_parallel"](small, *traj)
        coords = st["coords_from_traj"](traj[0], traj[1])
        return {"traj": traj, "tracked": tracked, "coords": coords,
                "crops": st["sample"](x, *coords),
                "window": st["traj_window"](traj[0], h, w, LIP_ROI)}

    dev = chain(clips)
    peak = torch.cuda.max_memory_allocated()

    ref = chain(clips.cpu())
    same_coords = st["sample"](clips.cpu(), *[c.cpu() for c in dev["coords"]])
    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
    ok_d, ok_c = np_(dev["traj"][2]), np_(ref["traj"][2])
    win_d, win_c = [np_(x) for x in dev["window"]], [np_(x) for x in ref["window"]]
    traj_err = float(np.abs(np_(dev["traj"][0]) - np_(ref["traj"][0])).max())
    face_err = float(np.abs(np_(dev["traj"][1]) - np_(ref["traj"][1])).max())
    track_err = float(np.abs(np_(dev["tracked"][0]) - np_(ref["tracked"][0])).max())
    coord_err = max(float(np.abs(np_(g) - np_(c)).max()) for g, c in zip(dev["coords"], ref["coords"]))
    sample_err = float(np.abs(np_(dev["crops"]) - np_(same_coords)).max())
    crop_err = float(np.abs(np_(dev["crops"]) - np_(ref["crops"])).max())

    # extract_lip_clip: MotionEnergyDetector landmarks of clip 0 (host, at
    # detection scale, scaled up as HostLipCropper's interp mode does)
    frames = np_(clips[0])
    sparse = MotionEnergyDetector()(frames[:, ::2, ::2], window=25)
    sparse = [None if l is None else l * 2 for l in sparse]
    lms = smooth_landmarks(landmarks_interpolate(sparse), 12)
    lip_dev = extract_lip_clip(frames, sparse, device=device)
    lip_cpu = extract_lip_clip(frames, sparse, device="cpu")
    mf = torch.from_numpy(canonical_mean_face(300))
    win = [_crop_window_coeffs(torch.from_numpy(lms).to(d), mf.to(d), 300, 96, STABLE_IDX)[1:]
           for d in (device, "cpu")]
    win_equal = all(bool((a.cpu() == b_.cpu()).all()) for a, b_ in zip(*win))
    extract_err = int(np.abs(lip_dev.astype(int) - lip_cpu.astype(int)).max())

    log({"phase": "lip_frontend", "card": card, "shape": {"B": b, "T": t, "H": h, "W": w},
         "detect_ds": 2, "window": 25, "max_memory_allocated_bytes": peak,
         "ok": ok_d.tolist(), "ok_equal": bool((ok_d == ok_c).all()),
         "window_offsets": [x.tolist() for x in win_d],
         "window_offsets_equal": all(bool((a == c).all()) for a, c in zip(win_d, win_c)),
         "traj_max_abs_err_px": traj_err, "face_w_max_abs_err_px": face_err,
         "tracked_max_abs_err_px": track_err, "coords_max_abs_err_px": coord_err,
         "sample_max_abs_err": sample_err, "crops_max_abs_err": crop_err,
         "tolerance": {"traj_px": LIP_TRAJ_TOL, "tracked_px": LIP_TRACK_TOL,
                       "sample": LIP_SAMPLE_TOL, "coords_px": LIP_COORD_TOL,
                       "crops": LIP_CROP_TOL},
         "extract_lip_clip": {"windows_equal": win_equal,
                              "max_abs_err_grey": extract_err,
                              "frames_with_landmarks": sum(l is not None for l in sparse)}})
    if not ok_d.all():
        raise AssertionError(f"the lip frontend missed a face in the closeups: ok {ok_d}")
    if not (ok_d == ok_c).all() or not all((a == c).all() for a, c in zip(win_d, win_c)):
        raise AssertionError(f"card-vs-cpu decisions differ: ok {ok_d} / {ok_c}, windows {win_d} / {win_c}")
    if traj_err > LIP_TRAJ_TOL or face_err > LIP_TRAJ_TOL or track_err > LIP_TRACK_TOL:
        raise AssertionError(f"card-vs-cpu trajectories differ: {traj_err}, {face_err}, {track_err} px")
    if coord_err > LIP_COORD_TOL:
        raise AssertionError(f"card-vs-cpu sampling coordinates differ by {coord_err} px")
    if sample_err > LIP_SAMPLE_TOL or crop_err > LIP_CROP_TOL:
        raise AssertionError(f"card-vs-cpu crops differ: sampler {sample_err}, chain {crop_err}")
    if lip_dev is None or not win_equal or extract_err > 1:
        raise AssertionError(f"extract_lip_clip card-vs-cpu: windows equal {win_equal}, "
                             f"max err {extract_err}")


def raw_batches(items, batch: int, audio_max_length: int, video_frames: int, hw, crop: int,
                seed: int, device):
    """(items, PreparedBatch) pairs for ``items`` (dicts with "audio" and,
    for a raw closeup, "raw_frames"), as ``StreamingTranscriber._prepare_batch``
    builds them from decoded closeups: uint8 clips zero past their frame
    count, zero video rows. The clips are made on ``device`` and brought to
    the host, where a decoder would leave them."""
    from avsl_tpu_torch.infer.pipeline import PreparedBatch

    out = []
    for s in range(0, len(items), batch):
        chunk = items[s:s + batch]
        clips = closeup_clips(batch, video_frames, hw[0], hw[1], seed=seed + s, device=device)
        clips = clips.cpu().numpy()
        audio = np.zeros((batch, audio_max_length), np.float32)
        raw = np.zeros((batch, video_frames) + tuple(hw), np.uint8)
        mask = np.zeros(batch, bool)
        n_frames = np.zeros(batch, np.int32)
        for i, item in enumerate(chunk):
            a = item["audio"][:audio_max_length]
            audio[i, : len(a)] = a
            if "raw_frames" in item:
                n = item["raw_frames"]
                raw[i, :n] = clips[i, :n]
                mask[i], n_frames[i] = True, n
        video = np.zeros((batch, video_frames, crop, crop, 1), np.float32)
        out.append((chunk, PreparedBatch(audio, video, raw, mask, n_frames,
                                         [bool(m) for m in mask[: len(chunk)]])))
    return out


def phase_av_raw_main_path(card: str, model, serve_cfg) -> int:
    """Whisper-Flamingo serving raw closeups at full width (phase 7): the
    model of ``av_main_path`` through a StreamingTranscriber in
    ``raw_lip_mode="device"`` at the JAX CLI's shape (raw_video_hw 288 x 352,
    250 frames, batch 8): 16 items of 7.5-10 s, 12 with raw closeups of
    150-250 frames, 4 audio-only, driven through the transcriber's device
    method ``run_batch`` (the card's machine has no video decoder). K1's
    launches are read around exactly that run; the lip frontend must detect
    every served closeup of a batch and feed its rows, and zeroing a
    batch's raw clips must move its rows' first-step logits."""
    from avsl_tpu_torch.cli._serving_common import serving_video_frames
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram

    cfg, av_cfg = model.cfg, model.video_model.cfg
    batch, n_items, max_new = 8, 16, 64
    audio_max_length = int(serve_cfg.audio_max_length)
    video_frames = serving_video_frames(audio_max_length)
    tr = StreamingTranscriber(model, ByteTokenizer(), audio_max_length=audio_max_length,
                              video_frames=video_frames, crop=88, batch_size=batch,
                              max_new_tokens=max_new, raw_lip_mode="device")
    items = av_items(n_items, seed=2)
    for item in items:  # the lip features' frame counts become raw closeups'
        if "lip_feats" in item:
            item["raw_frames"] = len(item.pop("lip_feats"))
    prepared = raw_batches(items, batch, audio_max_length, video_frames, tr.raw_video_hw, tr.crop,
                           seed=21, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def serve():
        out = []
        for chunk, prep in prepared:
            out += tr._results(chunk, prep.flags, tr.run_batch(prep), len(out))
        return out

    results, launches, stats_writes, k2 = run_counted(serve)
    peak = torch.cuda.max_memory_allocated()
    if stats_writes or k2:
        raise AssertionError("the raw AV serving path wrote row statistics or ran the backward kernel")
    n_batches = math.ceil(n_items / batch)
    check_served(results, n_items, max_new)
    per_batch = cfg.n_audio_layer + av_cfg.num_hidden_layers
    if launches != per_batch * n_batches:
        raise AssertionError(f"flash-attention launches {launches} != {per_batch * n_batches}")
    with_video = [r.id for r in results if r.has_video]
    if with_video != [it["id"] for it in items if "raw_frames" in it] or len(with_video) != 12:
        raise AssertionError(f"has_video on {with_video}")

    # one batch: its detections; the lip rows it feeds the model
    _, prep = prepared[0]
    st = tr._lip_stages
    with torch.inference_mode():
        raw = torch.from_numpy(prep.raw).cuda()
        n_frames = torch.from_numpy(prep.raw_frames).cuda()
        lip = tr._lip_from_raw(raw, n_frames)
        ok = st["traj"](st["subsample"](raw))[2].cpu().tolist()
        rows_with_frames = (lip.flatten(1).abs().amax(dim=1) > 0).cpu().tolist()
        mask = torch.from_numpy(prep.raw_mask).cuda()[:, None, None, None, None]
        mel = log_mel_spectrogram(torch.from_numpy(prep.audio).cuda(), n_mels=cfg.n_mels)
        prompt = tr._prompt

        def first_logits(clips):
            video = torch.where(mask, tr._lip_from_raw(clips, n_frames), 0.0)
            feats, xv = model.encode(mel, video)
            logits, _ = model.decode(prompt, None, None,
                                     model.init_decode_cache(feats, xv, prompt.shape[1] + 2))
            return logits[:, -1].float()

        moved = (first_logits(raw) - first_logits(torch.zeros_like(raw))).abs().amax(dim=-1)
    moved = moved.cpu().tolist()
    log({"phase": "av_raw_main_path", "card": card, "items": n_items, "batches": n_batches,
         "items_with_video": len(with_video), "raw_video_hw": list(tr.raw_video_hw),
         "video_frames": video_frames, "raw_lip_mode": tr.raw_lip_mode,
         "decode_tokens": decoded_tokens(results, tr.tokenizer.eot, max_new),
         "max_memory_allocated_bytes": peak, "flash_attention_launches": launches,
         "row_statistics_written": stats_writes, "backward_launches": k2,
         "detections_ok_batch0": ok, "lip_rows_with_frames_batch0": rows_with_frames,
         "first_step_logit_change_by_row": moved, "rows_with_video": prep.flags})
    if not all(o for o, m in zip(ok, prep.raw_mask) if m):
        raise AssertionError(f"the lip frontend missed a served closeup: ok {ok}, "
                             f"closeups {prep.raw_mask}")
    if rows_with_frames != [bool(m) for m in prep.raw_mask]:
        raise AssertionError(f"lip rows with frames {rows_with_frames}, closeups {prep.raw_mask}")
    if min(m for m, f in zip(moved, prep.flags) if f) < 1e-3:
        raise AssertionError(f"zeroing the raw clips left rows' first-step logits unchanged: {moved}")
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


def train_steps(runner, reshaped, after_first):
    """Each batch through the runner's train step: ``(records,
    after_first())``, the latter called once step 1 has run."""
    opt, records, first = runner.state.optimizer, [], None
    for i, batch in enumerate(reshaped):
        lr = opt.learning_rate()
        runner.state, metrics = runner.train_step(runner.state, batch)
        records.append({"step": i + 1, "lr": lr, "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "label_tokens": int((batch["labels"] >= 0).sum()),
                        "label_len": int(batch["labels"].shape[-1])})
        if i == 0:
            first = after_first()
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"non-finite loss or grad_norm: {records}")
    return records, first


def check_step_grads(model, loss_fn, batch, gen, accum: int, check_grads) -> None:
    """One more step's micro-steps, forward and backward, then
    ``check_grads()`` on the accumulated gradients, which are then
    dropped."""
    for i in range(accum):
        loss, _ = loss_fn({k: v[i] for k, v in batch.items()}, gen)
        loss.backward()
    check_grads()
    model.zero_grad(set_to_none=True)


def phase_train_main_path(card: str, cfg, tokenizer, batches, out_dir: str):
    """Whisper large-v2 widths, audio-only, fp32 weights and Adam state
    under bf16 compute, trained as the port's whisper_ft composes it
    (flamingo_loss_fn with dropout and no SpecAugment, whisper_optimizer,
    TrainerRunner's step): 3 optimizer steps of batch 1 x accumulation
    16, with the kernels' launches read around exactly those steps; then
    one more step's gradients checked for a nonzero gradient on every
    trained tensor. The runner's logs would go to ``out_dir``."""
    from avsl_tpu_torch.cli import whisper_ft
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn

    model, w_cfg = whisper_ft.build_model(cfg, tokenizer, "cuda", vocab_size=LARGE_V2_VOCAB)
    params = [p for p in model.parameters()]
    log({"phase": "build_train_model", "model": w_cfg.name, "n_vocab": w_cfg.n_vocab,
         "params": sum(p.numel() for p in params), "dtype": w_cfg.dtype,
         "param_dtype": w_cfg.param_dtype, "dropout": w_cfg.dropout_rate,
         "spec_augment": None, "learning_rate": cfg.learning_rate,
         "warmup_steps": cfg.warmup_steps, "batch_size": cfg.batch_size,
         "accumulation": cfg.gradient_accumulation_steps})
    runner = whisper_ft.make_runner(cfg, model, tokenizer, out_dir)
    opt, accum = runner.state.optimizer, runner.accum
    reshaped = [runner.reshape_accum(b) for b in batches]
    n_steps = len(reshaped)
    torch.cuda.reset_peak_memory_stats()

    before = [p.detach().clone() for p in params]
    fused_attention.launches = fused_attention_bwd.launches = 0
    records, unchanged_after_first = train_steps(
        runner, reshaped, lambda: all(torch.equal(a, p) for a, p in zip(before, params)))
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int((a != p).sum()) for a, p in zip(before, params))
    n_elems = sum(p.numel() for p in params)
    del before

    micro_steps = n_steps * accum
    per_micro = 3 * w_cfg.n_audio_layer  # encoder self, decoder self, cross
    log({"phase": "train_main_path", "card": card, "steps": records,
         "max_memory_allocated_bytes": peak, "k1_launches": k1, "k2_launches": k2,
         "micro_steps": micro_steps, "expected_launches": per_micro * micro_steps,
         "params_unchanged_after_step_1": unchanged_after_first,
         "param_elements_changed_share": changed / n_elems})
    if k1 != per_micro * micro_steps or k2 != per_micro * micro_steps:
        raise AssertionError(f"launches K1 {k1} / K2 {k2} != {per_micro * micro_steps}")
    if not unchanged_after_first:
        raise AssertionError("step 1 (learning rate 0) changed the parameters")
    if changed / n_elems < 0.5:
        raise AssertionError(f"only {changed / n_elems:.3f} of the parameters changed in 3 steps")

    # one more step's gradients
    loss_fn = flamingo_loss_fn(model, train=True)  # as whisper_ft: no SpecAugment
    batch = batch_to_device(reshaped[-1], model.device)

    def check_grads():
        zero = [n for n, p in model.named_parameters() if p.grad is None or not bool(p.grad.any())]
        if zero:
            raise AssertionError(f"{len(zero)} trained tensors got no gradient, e.g. {zero[:4]}")

    check_step_grads(model, loss_fn, batch, runner.state.generator, accum, check_grads)
    log({"phase": "train_grads_checked", "card": card, "micro_steps": accum,
         "trained_tensors_with_gradient": len(opt.params)})
    return {"k1": k1, "k2": k2}


def _tiny_flamingo_step(model, freeze_bn: bool, hoist: bool):
    """The Flamingo regime's optimizer, loss and train step (accumulation
    2) over ``model``; the towers hoisted when ``hoist``."""
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_train_step, select_optimizer
    from avsl_tpu_torch.train.objectives import flamingo_tower_precompute

    tcfg = FlamingoTrainConfig(learning_rate=1e-3, warmup_steps=1, num_train_steps=10)
    opt, labels = select_optimizer(model, tcfg, 10)
    mixing = dict(prob_av=1.0, prob_a=0.5)  # the config's: a draw each micro-step, always AV
    loss_fn = flamingo_loss_fn(model, train=True, freeze_video_bn_stats=freeze_bn, **mixing)
    pre = flamingo_tower_precompute(model, train=True, **mixing) if hoist else None
    step = make_train_step(loss_fn, grad_accum_steps=2, param_labels=labels, precompute_fn=pre)
    return loss_fn, TrainState.create(model, opt), step, labels


def _tiny_flamingo(device, seed: int = 3):
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_whisper_flamingo

    av_cfg = AVHuBERTConfig.tiny_test(dtype="float32", **SMALL_AV_OVERRIDES, **ZERO_AV_RATES)
    model, cfg = build_whisper_flamingo("test", vocab_size=300, add_gated_x_attn=1,
                                        av_hubert_cfg=av_cfg, dtype="float32",
                                        param_dtype="float32", device=device, seed=seed)
    set_gates(model, GATE)
    return model, cfg


def _tiny_flamingo_batches(cfg, n_steps: int = 3):
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(n_steps):
        labels = rng.integers(0, 300, size=(2, 2, 9))
        labels[:, :, 6:] = -100
        batches.append({
            "input_ids": rng.normal(size=(2, 2, cfg.n_mels, 100)).astype(np.float32),
            "dec_input_ids": rng.integers(0, 300, size=(2, 2, 9)), "labels": labels,
            "video": rng.normal(size=(2, 2, 10, 88, 88, 1)).astype(np.float32),
            "video_mask": np.arange(10) < rng.integers(4, 11, size=(2, 2, 1)),
        })
    return batches


def _bn_stats(model) -> dict:
    return {n: b.detach().float().cpu().clone() for n, b in model.named_buffers()
            if "running_" in n}


def phase_small_flamingo_train_reference():
    """The tiny Whisper-Flamingo model (tower at 2 heads of 32, gates 0.5,
    fp32, every dropout and LayerDrop 0) trained under the Flamingo regime
    with BatchNorm on batch statistics: 3 accumulated steps of 2
    micro-batches of 2 on the card (K1 + K2) against the CPU (plain), from
    the same weights: per-step loss and grad_norm, the step-1 gradients of
    the trained tensors, and the BatchNorm running statistics after step
    3. Then, with BatchNorm frozen, the hoisted step against the in-scan
    step on the card."""
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.optim import TRAIN

    tol = SMALL_FLAMINGO_TOL
    card, cfg = _tiny_flamingo("cuda")
    cpu, _ = _tiny_flamingo("cpu")
    cpu.load_state_dict(card.state_dict())
    batches = _tiny_flamingo_batches(cfg)
    runs = [(m, *_tiny_flamingo_step(m, freeze_bn=False, hoist=False)) for m in (card, cpu)]
    grads = []
    for model, loss_fn, state, _, labels in runs:
        for name, p in model.named_parameters():
            p.requires_grad_(labels[name] == TRAIN)
        batch = batch_to_device(batches[0], model.device)
        for i in range(2):
            loss, _ = loss_fn({k: v[i] for k, v in batch.items()}, None)
            loss.backward()
        grads.append({n: p.grad.detach().cpu() / 2 for n, p in model.named_parameters()
                      if p.grad is not None})
        model.zero_grad(set_to_none=True)
    if sorted(grads[0]) != sorted(grads[1]) or not grads[0]:
        raise AssertionError("the card and the CPU trained different tensors")
    grad_err = max((grads[0][n] - g).abs().max().item() for n, g in grads[1].items())
    grad_ok = all(bool(((grads[0][n] - g).abs() <= tol["atol"] + tol["rtol"] * g.abs()).all())
                  for n, g in grads[1].items())
    steps = []
    for batch in batches:
        got = []
        for _, _, state, step, _ in runs:
            _, metrics = step(state, batch)
            got.append({k: float(v) for k, v in metrics.items()})
        steps.append({"card": got[0], "cpu": got[1]})
    rel = max(abs(st["card"][k] - st["cpu"][k]) / abs(st["cpu"][k])
              for st in steps for k in ("loss", "grad_norm"))
    stats = [_bn_stats(m) for m in (card, cpu)]
    stats_err = max((stats[0][n] - v).abs().max().item() for n, v in stats[1].items())
    stats_ok = all(bool(((stats[0][n] - v).abs() <= tol["atol"] + tol["rtol"] * v.abs()).all())
                   for n, v in stats[1].items())
    stats_moved = max((v - 1.0 if n.endswith("var") else v).abs().max().item()
                      for n, v in stats[1].items())

    # BatchNorm frozen: the hoisted step against the in-scan step, both on the card
    base = {k: v.clone() for k, v in card.state_dict().items()}
    hoist_steps, frozen_stats = [], []
    for hoist in (False, True):
        model, _ = _tiny_flamingo("cuda")
        model.load_state_dict(base)
        _, state, step, _ = _tiny_flamingo_step(model, freeze_bn=True, hoist=hoist)
        before = _bn_stats(model)
        hoist_steps.append([{k: float(v) for k, v in step(state, b)[1].items()} for b in batches])
        frozen_stats.append(all(torch.equal(before[n], v) for n, v in _bn_stats(model).items()))
    hoist_rel = max(abs(h[k] - i[k]) / abs(i[k]) for i, h in zip(*hoist_steps)
                    for k in ("loss", "grad_norm"))
    log({"phase": "small_flamingo_train_reference", "steps": steps,
         "step1_trained_grad_max_abs_err": grad_err, "trained_tensors": len(grads[0]),
         "metric_max_rel_err": rel, "batch_stats_max_abs_err": stats_err,
         "batch_stats_moved_by": stats_moved, "hoisted_vs_in_scan_max_rel_err": hoist_rel,
         "frozen_batch_stats_unchanged": frozen_stats, "tolerance": tol})
    finite = all(math.isfinite(v) for st in steps for d in st.values() for v in d.values())
    if not finite or not grad_ok or rel > tol["rtol"]:
        raise AssertionError(f"tiny Flamingo train card-vs-cpu: grads {grad_err:.3e}, "
                             f"metrics {rel:.3e}")
    if not stats_ok or stats_moved < 1e-3:
        raise AssertionError(f"tiny Flamingo BatchNorm statistics: card-vs-cpu {stats_err:.3e}, "
                             f"moved {stats_moved:.3e}")
    if hoist_rel > tol["rtol"] or not all(frozen_stats):
        raise AssertionError(f"tiny Flamingo hoisted vs in-scan {hoist_rel:.3e}, "
                             f"frozen statistics unchanged {frozen_stats}")


def prepare_flamingo_path(steps: int):
    """The full-width Whisper-Flamingo training inputs as the port's
    cli/finetune composes them from the training YAML: (cfg, tokenizer,
    collated batches of batch_size x accumulation items, label length).
    Each item gets 250 frames of seeded lip features [T, 88, 88, 1] in
    place of the clip the dataset would decode (the card's machine has no
    OpenCV); the labels are pinned to the YAML's text_max_length."""
    from avsl_tpu_torch.cli import finetune, whisper_ft
    from avsl_tpu_torch.core.config import FlamingoTrainConfig, WhisperConfig
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    cfg = FlamingoTrainConfig.from_yaml(TRAIN_CONFIG)
    cfg.gradient_accumulation_steps = PATH_ACCUM
    tokenizer = get_tokenizer(cfg.download_root or None, cfg.lang)
    tokenizer.add_tokens(["<laugh>"])
    w_cfg = WhisperConfig.from_name(cfg.model_name)
    per_step = int(cfg.batch_size) * int(cfg.gradient_accumulation_steps)
    ds = finetune.make_dataset(train_rows(per_step * steps, seed=1), tokenizer, cfg, w_cfg,
                               train=True)
    rng = np.random.default_rng(2)
    items = []
    for i in range(len(ds)):
        item = ds[i]
        item["video"] = rng.standard_normal((VIDEO_FRAMES, 88, 88, 1), dtype=np.float32)
        items.append(item)
    collator = finetune.make_collator(tokenizer, cfg, w_cfg)
    batches = list(whisper_ft.batches(items, collator, per_step, True, 0))
    return cfg, tokenizer, batches, batches[0]["labels"].shape[1]


def phase_flamingo_train_main_path(card: str, cfg, tokenizer, batches, out_dir: str,
                                   hoisted: bool):
    """Whisper-Flamingo fine-tuning at full width (large-v2 + AV-HuBERT
    large), composed as the port's cli/finetune composes the training
    YAML: fp32 weights with Adam for the trained tensors only (the
    Flamingo regime: gated x_attn/x_mlp, their gates, video_projection),
    bf16 compute, vocab 51866, batch 1 x accumulation PATH_ACCUM, 10 s windows and
    250 lip frames, SpecAugment ls-basic, Whisper dropout 0.1, the tower's
    dropouts and LayerDrop 0.05, gates 0.5. With ``hoisted`` the YAML's
    BatchNorm freeze is turned on, which engages the frozen-tower hoist;
    else BatchNorm trains on batch statistics, towers in the loop. 3
    optimizer steps with the kernels' launches and the tower's forwards
    counted around exactly those steps; then one more step's gradients
    checked: on every trained tensor and on no frozen one."""
    import copy
    import os

    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn, flamingo_tower_precompute

    name = "flamingo_train_hoisted" if hoisted else "flamingo_train"
    cfg = copy.copy(cfg)
    cfg.freeze_video_batch_norm_stats = hoisted
    model, w_cfg = finetune.build_model(cfg, tokenizer, "cuda", vocab_size=LARGE_V2_VOCAB)
    set_gates(model, GATE)
    runner = finetune.make_runner(cfg, model, tokenizer, log_dir=os.path.join(out_dir, name),
                                  ckpt_dir=os.path.join(out_dir, name, "ckpt"))
    if runner.hoisted != hoisted:
        raise AssertionError(f"the hoist gate said {runner.hoisted}, expected {hoisted}")
    opt, accum = runner.state.optimizer, runner.accum
    named = dict(model.named_parameters())
    trained = set(opt.names)
    av_cfg = model.video_model.cfg
    count = lambda ps: sum(p.numel() for p in ps)  # noqa: E731
    log({"phase": f"build_{name}", "model": w_cfg.name, "n_vocab": w_cfg.n_vocab,
         "params": count(named.values()), "trained_params": count(named[n] for n in trained),
         "trained_tensors": len(trained), "video_tower_params": count(model.video_model.parameters()),
         "dtype": w_cfg.dtype, "param_dtype": w_cfg.param_dtype,
         "whisper_dropout": w_cfg.dropout_rate,
         "tower_dropouts": {k: getattr(av_cfg, k) for k in (
             "hidden_dropout", "attention_dropout", "activation_dropout", "dropout_input",
             "layerdrop", "feature_grad_mult")},
         "freeze_video_batch_norm_stats": hoisted, "hoisted": runner.hoisted,
         "spec_augment": cfg.spec_augment, "prob_use_av": cfg.prob_use_av,
         "prob_use_a": cfg.prob_use_a, "learning_rate": cfg.learning_rate,
         "warmup_steps": cfg.warmup_steps, "batch_size": cfg.batch_size, "accumulation": accum,
         "video_frames": VIDEO_FRAMES, "gates": GATE})
    if not all(("x_attn" in n or "x_mlp" in n or "video_projection" in n) for n in trained):
        raise AssertionError(f"the Flamingo regime trains {sorted(trained)[:4]}...")
    reshaped = [runner.reshape_accum(b) for b in batches]
    n_steps = len(reshaped)
    before = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
    stats0 = _bn_stats(model)
    tower_calls = []
    hook = model.video_model.register_forward_hook(lambda *args: tower_calls.append(1))
    torch.cuda.reset_peak_memory_stats()

    fused_attention.launches = fused_attention_bwd.launches = 0
    records, unchanged_after_first = train_steps(
        runner, reshaped,
        lambda: all(torch.equal(named[n].detach().cpu(), before[n]) for n in trained))
    k1, k2, n_tower = fused_attention.launches, fused_attention_bwd.launches, len(tower_calls)
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    frozen_same = [n for n, p in named.items()
                   if n not in trained and not torch.equal(p.detach().cpu(), before[n])]
    changed = sum(int((named[n].detach().cpu() != before[n]).sum()) for n in trained)
    n_trained = sum(named[n].numel() for n in trained)
    del before
    stats = _bn_stats(model)
    stats_moved = max((stats[n] - v).abs().max().item() for n, v in stats0.items())

    micro_steps = n_steps * accum
    enc, dec = w_cfg.n_audio_layer, 3 * w_cfg.n_text_layer  # decoder: self, cross, x_attn
    # K1: the frozen Whisper encoder (no row statistics) once a micro-step,
    # or once a step over all 16 items when hoisted, and the decoder's 96
    # with row statistics a micro-step; the tower's attention in training
    # runs unfused (attention dropout 0.1), so no K1 there. K2: the
    # decoder's 96 a micro-step (frozen towers have no backward).
    want_k1 = enc * (n_steps if hoisted else micro_steps) + dec * micro_steps
    want_k2 = dec * micro_steps
    want_tower = n_steps if hoisted else micro_steps
    log({"phase": name, "card": card, "steps": records,
         "max_memory_allocated_bytes": peak, "k1_launches": k1, "k2_launches": k2,
         "expected_k1": want_k1, "expected_k2": want_k2, "micro_steps": micro_steps,
         "tower_forwards": n_tower, "expected_tower_forwards": want_tower,
         "params_unchanged_after_step_1": unchanged_after_first,
         "trained_elements_changed_share": changed / n_trained,
         "frozen_tensors_changed": len(frozen_same), "batch_stats_moved_by": stats_moved})
    if (k1, k2) != (want_k1, want_k2):
        raise AssertionError(f"{name}: launches K1 {k1} / K2 {k2} != {want_k1} / {want_k2}")
    if n_tower != want_tower:
        raise AssertionError(f"{name}: {n_tower} tower forwards, expected {want_tower}")
    if not unchanged_after_first:
        raise AssertionError(f"{name}: step 1 (learning rate 0) changed the parameters")
    if frozen_same:
        raise AssertionError(f"{name}: {len(frozen_same)} frozen tensors changed, "
                             f"e.g. {frozen_same[:4]}")
    if changed / n_trained < 0.5:
        raise AssertionError(f"{name}: only {changed / n_trained:.3f} of the trained elements "
                             "changed in 3 steps")
    if hoisted and stats_moved != 0.0:
        raise AssertionError(f"{name}: frozen BatchNorm statistics moved by {stats_moved:.3e}")
    if not hoisted and stats_moved < 1e-6:
        raise AssertionError(f"{name}: BatchNorm statistics did not move")

    # one more step's gradients
    mixing = dict(spec_augment=cfg.spec_augment, prob_av=float(cfg.prob_use_av),
                  prob_a=float(cfg.prob_use_a))
    loss_fn = flamingo_loss_fn(model, train=True, freeze_video_bn_stats=hoisted, **mixing)
    gen = runner.state.generator
    batch = batch_to_device(reshaped[-1], model.device)
    if hoisted:
        batch = {**batch, **flamingo_tower_precompute(model, train=True, **mixing)(batch, gen)}

    def check_grads():
        zero = [n for n in opt.names if named[n].grad is None or not bool(named[n].grad.any())]
        with_grad = [n for n, p in named.items() if n not in trained and p.grad is not None]
        if zero or with_grad:
            raise AssertionError(f"{name}: {len(zero)} trained tensors got no gradient "
                                 f"({zero[:4]}), {len(with_grad)} frozen ones got one")

    check_step_grads(model, loss_fn, batch, gen, accum, check_grads)
    log({"phase": f"{name}_grads_checked", "card": card, "micro_steps": accum,
         "trained_tensors_with_gradient": len(opt.names)})
    return {"k1": k1, "k2": k2}


# the dataset path: 8 x 10 s clips at each native rate resampled to 16 kHz,
# card against CPU and against float64 scipy upfirdn with the same taps
RESAMPLE_RATES = (44100, 48000, 8000)
RESAMPLE_ITEMS, RESAMPLE_SECONDS = 8, 10
RESAMPLE_TOL = 1e-5
# rows as cli/finetune's load_datasets gives them (train, val, test), fed in
# memory: the card's machine has no `datasets` package and no OpenCV
# train, val and test rows (val and test were 8 before the AV-HuBERT tools'
# phases: cut to make room for them)
DATASET_ROWS = (128, 4, 4)
DATASET_STEPS = 2
# tiny Flamingo under MultiSteps: bucketed micro-batches of these sizes
MULTISTEPS_SIZES = (3, 1, 2, 4, 2, 3)


def resample_golden(x, up: int, down: int, taps):
    """The resampler's function in float64 from scipy's ``upfirdn`` with the
    same taps: zero-stuff, convolve, decimate; the taps are shifted so the
    decimation lands on the centred FIR's outputs."""
    from scipy.signal import upfirdn

    half = (len(taps) - 1) // 2
    shift = (-half) % down
    h = np.concatenate([np.zeros(shift), np.asarray(taps, np.float64)])
    start = (half + shift) // down
    out_len = -(-x.shape[-1] * up // down)
    return upfirdn(h, x.astype(np.float64), up, down, axis=-1)[..., start:start + out_len]


def phase_resample(card: str):
    """``resample_poly`` on 8 x 10 s at 44.1, 48 and 8 kHz to 16 kHz: the
    card against the CPU and against :func:`resample_golden`, each within
    RESAMPLE_TOL."""
    from avsl_tpu_torch.kernels.resample import _design_filter, resample_poly

    rng = np.random.default_rng(12)
    cases = []
    for sr in RESAMPLE_RATES:
        g = math.gcd(sr, 16000)
        up, down = 16000 // g, sr // g
        x = (0.3 * rng.standard_normal((RESAMPLE_ITEMS, RESAMPLE_SECONDS * sr))).astype(np.float32)
        got = resample_poly(torch.from_numpy(x).cuda(), sr, 16000)
        cpu = resample_poly(x, sr, 16000)
        gold = resample_golden(x, up, down, _design_filter(up, down))
        cases.append({"rate": sr, "up": up, "down": down, "shape": list(got.shape),
                      "card_vs_cpu_max_abs_err": (got.cpu() - cpu).abs().max().item(),
                      "card_vs_golden_max_abs_err": float(np.abs(got.cpu().numpy() - gold).max())})
    log({"phase": "resample", "card": card, "cases": cases, "tolerance": RESAMPLE_TOL})
    bad = [c for c in cases if max(c["card_vs_cpu_max_abs_err"],
                                   c["card_vs_golden_max_abs_err"]) > RESAMPLE_TOL]
    if bad:
        raise AssertionError(f"resample_poly off by more than {RESAMPLE_TOL}: {bad}")


def _tiny_bucketed_batches(cfg, sizes=MULTISTEPS_SIZES):
    """Collated tiny Flamingo micro-batches of ``sizes`` items: labels of 6
    tokens in 9, 10 lip frames with 4-10 real."""
    rng = np.random.default_rng(9)
    batches = []
    for b in sizes:
        labels = rng.integers(0, 300, size=(b, 9))
        labels[:, 6:] = -100
        batches.append({
            "input_ids": rng.normal(size=(b, cfg.n_mels, 100)).astype(np.float32),
            "dec_input_ids": rng.integers(0, 300, size=(b, 9)), "labels": labels,
            "video": rng.normal(size=(b, 10, 88, 88, 1)).astype(np.float32),
            "video_mask": np.arange(10) < rng.integers(4, 11, size=(b, 1)),
        })
    return batches


def phase_multisteps_small(out_dir: str):
    """The tiny Whisper-Flamingo model (every rate 0, fp32, BatchNorm on
    batch statistics) trained through ``cli.finetune.make_runner`` with
    ``cross_batch``: MultiSteps with accumulation 2 over micro-batches of
    3, 1, 2, 4, 2 and 3 items, on the card (K1 + K2) and on the CPU from
    the same weights. After every micro-step: loss and grad_norm within
    the tiny train tolerance, the trained tensors within it too, and
    unchanged after the odd micro-steps on both."""
    import os

    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.tokenizer import get_tokenizer

    tol = SMALL_FLAMINGO_TOL
    tcfg = FlamingoTrainConfig(learning_rate=1e-3, warmup_steps=1, num_train_steps=10,
                               gradient_accumulation_steps=2, add_gated_x_attn=1,
                               prob_use_av=1.0, prob_use_a=0.5, spec_augment=None,
                               freeze_video_batch_norm_stats=False)
    card, cfg = _tiny_flamingo("cuda")
    cpu, _ = _tiny_flamingo("cpu")
    cpu.load_state_dict(card.state_dict())
    runners = [finetune.make_runner(tcfg, m, get_tokenizer(None, "en"),
                                    log_dir=os.path.join(out_dir, f"ms_{i}"),
                                    ckpt_dir=os.path.join(out_dir, f"ms_{i}", "ckpt"),
                                    cross_batch=True)
               for i, m in enumerate((card, cpu))]
    if any(r.accum != 1 or r.hoisted for r in runners):
        raise AssertionError("cross-batch accumulation took the in-batch path")
    steps, moved, param_err, ok = [], [], 0.0, True
    for batch in _tiny_bucketed_batches(cfg):
        got, moves = [], []
        for r in runners:
            opt = r.state.optimizer
            before = [p.detach().clone() for p in opt.params]
            r.state, metrics = r.train_step(r.state, batch)
            got.append({k: float(v) for k, v in metrics.items()})
            moves.append(any(not torch.equal(a, p) for a, p in zip(before, opt.params)))
        steps.append({"items": int(batch["labels"].shape[0]), "card": got[0], "cpu": got[1]})
        moved.append(moves)
        for a, b in zip(*(r.state.optimizer.params for r in runners)):
            a, b = a.detach().cpu(), b.detach()
            param_err = max(param_err, (a - b).abs().max().item())
            ok = ok and bool(((a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()).all())
    rel = max(abs(st["card"][k] - st["cpu"][k]) / abs(st["cpu"][k])
              for st in steps for k in ("loss", "grad_norm"))
    counts = [r.state.optimizer.count for r in runners]
    log({"phase": "multisteps_small", "steps": steps, "moved": moved,
         "metric_max_rel_err": rel, "trained_max_abs_err": param_err, "updates": counts,
         "tolerance": tol})
    # updates on micro-steps 2, 4 and 6; the first has learning rate 0
    want_moved = [[i in (3, 5)] * 2 for i in range(len(steps))]
    if moved != want_moved or counts != [3, 3]:
        raise AssertionError(f"MultiSteps moved the parameters at {moved}, updates {counts}")
    if rel > tol["rtol"] or not ok:
        raise AssertionError(f"tiny MultiSteps card-vs-cpu: metrics {rel:.3e}, "
                             f"parameters {param_err:.3e}")


def dataset_rows(n: int, seed: int):
    """Rows as a dataset on disk holds them: 0.5-10 s of noise as int16 PCM,
    about a quarter at 44.1 or 48 kHz (resampled inside the dataset) and
    the rest at 16 kHz, a transcript of 20-200 characters of meeting
    vocabulary, the duration, and no lip clip (one zero frame an item)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        dur = float(rng.uniform(0.5, 10.0))
        sr = int(rng.choice([44100, 48000])) if rng.random() < 0.25 else 16000
        pcm = (0.1 * 32767 * rng.standard_normal(int(dur * sr))).astype(np.int16)
        rows.append({"audio": {"array": pcm, "sampling_rate": sr},
                     "transcript": _word_transcript(rng, int(rng.integers(20, 201))),
                     "duration": dur, "lip_video": None})
    return rows


def observe_steps(runner, records: list):
    """Wrap ``runner.train_step``: each micro-step's peak device memory,
    the batch's items, padded video frames and label tokens, the loss,
    whether the optimizer updated, and on the other micro-steps whether
    the trained tensors stayed bit-identical (against a device copy taken
    at each update). Returns the unwrapped step."""
    opt, plain = runner.state.optimizer, runner.train_step
    snapshot = [p.detach().clone() for p in opt.params]

    def step(state, batch):
        torch.cuda.reset_peak_memory_stats()
        state, metrics = plain(state, batch)
        loss = float(metrics["loss"])
        updated = opt.mini_step == 0
        if updated:
            torch._foreach_copy_(snapshot, [p.detach() for p in opt.params])
        labels = batch["labels"]
        records.append({
            "items": int(labels.shape[0]), "video_frames": int(batch["video"].shape[1]),
            "label_tokens": int((torch.as_tensor(labels) >= 0).sum()), "loss": loss,
            "grad_norm": float(metrics["grad_norm"]), "updated": updated,
            "unchanged": None if updated else all(
                torch.equal(a, p) for a, p in zip(snapshot, opt.params)),
            "peak_bytes": torch.cuda.max_memory_allocated()})
        return state, metrics

    runner.train_step = step
    return plain


def optimizer_steps(records: list) -> list:
    """Per optimizer update: its micro-batches, items, label tokens and
    the mean micro-batch loss."""
    out, cur = [], []
    for r in records:
        cur.append(r)
        if r["updated"]:
            out.append({"micro_batches": len(cur), "items": sum(c["items"] for c in cur),
                        "label_tokens": sum(c["label_tokens"] for c in cur),
                        "loss": statistics.mean(c["loss"] for c in cur)})
            cur = []
    return out


def phase_flamingo_dataset_train(card: str, out_dir: str):
    """Whisper-Flamingo fine-tuning on a dataset, at full width, through the
    port's ``cli.finetune.make_job`` and ``run`` (what ``main`` calls once
    ``load_datasets`` has run) on the training YAML: large-v2 + AV-HuBERT
    large, bf16 compute, batch 1 under a token budget of 1000 frames, so
    micro-batches of 1 to 10 items, accumulation PATH_ACCUM through MultiSteps.
    128 seeded train rows (a quarter at 44.1 or 48 kHz), 4 val and 4 test;
    DATASET_STEPS (2) optimizer steps (32 micro-batches), validation once at the end,
    ``test_best`` on the test rows. Gates: K1 and K2 launches equal to the
    count per micro-step and per eval batch, frozen tensors bit-identical,
    trained tensors unchanged on the micro-steps that do not update,
    exactly DATASET_STEPS updates, and K1 and K2 against their plain versions at every
    distinct shape the run launched them at. Returns the job (for the
    prefetch phase) and the launches."""
    import collections
    import os
    import shutil

    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train.optim import MultiSteps

    cfg = FlamingoTrainConfig.from_yaml(TRAIN_CONFIG)
    cfg.gradient_accumulation_steps = PATH_ACCUM
    accum = int(cfg.gradient_accumulation_steps)
    cfg.num_train_steps = DATASET_STEPS
    cfg.validate_every_n_batches = DATASET_STEPS * accum  # once, at the end
    cfg.num_sanity_val_steps = 0
    cfg.log_output_dir = os.path.join(out_dir, "dataset_logs")
    cfg.check_output_dir = os.path.join(out_dir, "dataset_ckpt")  # emptied after each run
    rows = [dataset_rows(n, seed) for n, seed in zip(DATASET_ROWS, (20, 21, 22))]
    job = finetune.make_job(cfg, *rows, "cuda", vocab_size=LARGE_V2_VOCAB)
    set_gates(job.model, GATE)
    runner, model = job.runner, job.model
    opt = runner.state.optimizer
    if not isinstance(opt, MultiSteps) or runner.accum != 1 or runner.hoisted:
        raise AssertionError(f"the dataset path composed {type(opt).__name__}, runner "
                             f"accumulation {runner.accum}, hoisted {runner.hoisted}")
    named = dict(model.named_parameters())
    trained = set(opt.names)
    # the YAML's remat is on, but nothing remat'd trains here: the Whisper
    # encoder and the tower are frozen, and the text decoder is not remat'd
    remat_trained = sorted(n for n in trained if n.split(".")[0] in ("encoder", "video_model"))
    if not (model.encoder.remat and model.video_model.encoder.remat) or remat_trained:
        raise AssertionError(f"dataset path: remat {model.encoder.remat}, trained tensors in "
                             f"remat'd stacks {remat_trained[:3]}")
    rates = collections.Counter(r["audio"]["sampling_rate"] for r in rows[0])
    log({"phase": "build_flamingo_dataset_train", "params": sum(p.numel() for p in named.values()),
         "trained_params": sum(named[n].numel() for n in trained),
         "rows": list(DATASET_ROWS), "native_rates": dict(rates),
         "batch_bins": (int(cfg.audio_max_length) // 160) * int(cfg.batch_size),
         "accumulation": accum, "optimizer_steps": DATASET_STEPS,
         "remat": model.encoder.remat})
    frozen_before = {n: p.detach().to("cpu", copy=True) for n, p in named.items()
                     if n not in trained}
    records, eval_calls = [], []
    plain_step = observe_steps(runner, records)
    plain_eval = runner.eval_logits_fn

    def counted_eval(state, batch):
        eval_calls.append(int(np.asarray(batch["labels"]).shape[0]))
        return plain_eval(state, batch)

    runner.eval_logits_fn = counted_eval
    seen: list = []
    with recorded(True, seen):
        fused_attention.launches = fused_attention_bwd.launches = 0
        result = finetune.run(job)
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    steps = optimizer_steps(records)
    frozen_changed = [n for n, v in frozen_before.items() if not torch.equal(named[n].cpu(), v)]
    del frozen_before
    moved_early = [i for i, r in enumerate(records) if not r["updated"] and not r["unchanged"]]
    by_size: dict = {}
    for r in records:
        by_size[r["items"]] = max(by_size.get(r["items"], 0), r["peak_bytes"])

    # K1: the frozen Whisper encoder and the decoder's self, cross and
    # x_attn in every micro-step (the tower trains with attention dropout,
    # unfused); every eval batch also runs the tower's 24 layers on K1.
    # K2: the decoder's three a micro-step.
    enc, dec = model.cfg.n_audio_layer, 3 * model.cfg.n_text_layer
    tower = model.video_model.cfg.num_hidden_layers
    micro = len(records)
    want_k1 = (enc + dec) * micro + (enc + tower + dec) * len(eval_calls)
    want_k2 = dec * micro
    log({"phase": "flamingo_dataset_train", "card": card, "optimizer_steps": steps,
         "micro_batch_items": dict(sorted(collections.Counter(r["items"] for r in records).items())),
         "micro_batch_padded_frames": dict(sorted(collections.Counter(
             4 * r["video_frames"] for r in records).items())),
         "peak_bytes_by_items": dict(sorted(by_size.items())),
         "max_memory_allocated_bytes": max(r["peak_bytes"] for r in records),
         "trained_snapshot_bytes": sum(p.numel() * p.element_size() for p in opt.params),
         "micro_steps": micro, "eval_batches": eval_calls,
         "k1_launches": k1, "k2_launches": k2, "expected_k1": want_k1, "expected_k2": want_k2,
         "k1_per_micro_step": enc + dec, "k2_per_micro_step": dec,
         "k1_per_eval_batch": enc + tower + dec, "updates": opt.count,
         "final_step": result["final_step"], "test": result.get("test"),
         "frozen_tensors_changed": len(frozen_changed),
         "trained_moved_before_update": moved_early})
    if (k1, k2) != (want_k1, want_k2):
        raise AssertionError(f"dataset path: launches K1 {k1} / K2 {k2} != {want_k1} / {want_k2}")
    if frozen_changed or moved_early:
        raise AssertionError(f"dataset path: {len(frozen_changed)} frozen tensors changed, "
                             f"trained tensors moved on micro-steps {moved_early}")
    if opt.count != DATASET_STEPS or sum(r["updated"] for r in records) != DATASET_STEPS \
            or result["final_step"] != DATASET_STEPS * accum or "test" not in result:
        raise AssertionError(f"dataset path: {opt.count} updates, final step "
                             f"{result['final_step']}, test {'test' in result}")
    if not all(math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"dataset path: non-finite loss {steps}")
    shutil.rmtree(cfg.check_output_dir, ignore_errors=True)
    log({"phase": "flamingo_dataset_launch_shapes", "card": card,
         "tolerance": {"bf16": BF16_TOL, "fp32": FP32_TOL, "bwd_fp32": BWD_FP32_TOL},
         **check_launch_shapes(seen)})
    runner.train_step, runner.eval_logits_fn = plain_step, plain_eval
    return job, {"k1": k1, "k2": k2}


def phase_prefetch(card: str, job):
    """Bucketed batches through ``prefetch_to_device`` arrive on the card
    equal to the host batches; then 2 optimizer steps of the dataset path
    through the runner's train step, fed by ``cli.finetune.train_batches``
    (what ``run`` feeds ``fit``) with ``prefetch_batches`` 2. ``fit``
    itself is not called here: it closes with a 17.5 GB checkpoint of the
    state, which the dataset phase has already written once, and the
    script keeps its disk writes small."""
    import itertools

    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.data.prefetch import prefetch_to_device

    cfg, runner = job.cfg, job.runner
    host = list(itertools.islice(job.batches(job.train_ds, int(cfg.batch_size), True, 2), 6))
    arrived = list(prefetch_to_device(iter(host), "cuda", size=2))
    equal = len(arrived) == len(host) and all(
        sorted(a) == sorted(h) and all(
            a[k].device.type == "cuda" and torch.equal(a[k].cpu(), torch.as_tensor(h[k]))
            for k in h)
        for a, h in zip(arrived, host))
    del arrived
    cfg.prefetch_batches = 2
    records = []
    plain = observe_steps(runner, records)
    it = finetune.train_batches(job, 3)
    for batch in itertools.islice(it, 2 * int(cfg.gradient_accumulation_steps)):
        runner.state, _ = runner.train_step(runner.state, batch)
    it.close()
    runner.train_step = plain
    cfg.prefetch_batches = 0
    log({"phase": "prefetch", "card": card, "batches_equal_on_card": equal,
         "batches_checked": len(host), "optimizer_steps_prefetched": optimizer_steps(records)})
    if not equal:
        raise AssertionError("prefetch_to_device changed or misplaced a batch")


def _tiny_avhubert(head: str, device):
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert

    cfg = AVHuBERTConfig.tiny_test(dtype="bfloat16", **ZERO_AVH_RATES, **SMALL_AVH_OVERRIDES)
    return build_avhubert(cfg, head, device=device, seed=3), cfg


def _tiny_avhubert_batches(head: str, pad_id: int, n_steps: int = 3):
    """The CLI's synthetic rows (12 frames of 48 x 48), cut to 12, 9, 10 or
    11 frames and collated 4 at a time: padded frames, and decoder tokens
    padded at the end (causal self-attention with key lengths)."""
    from avsl_tpu_torch.cli import avhubert_ft

    rows = avhubert_ft.make_synthetic_av_batchset(4 * n_steps, t=12, image=48, vocab=59, seed=3)
    for i, row in enumerate(rows):
        n = (12, 9, 10, 11)[i % 4]
        row["audio_feats"], row["video_feats"] = row["audio_feats"][:n], row["video_feats"][:n]
    batches = [avhubert_ft.collate_av(rows[4 * i:4 * i + 4], pad_id) for i in range(n_steps)]
    return [avhubert_ft.ctc_batch(b, pad_id) if head == "ctc" else b for b in batches]


def _rel_norm(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _tiny_avhubert_train(model, head: str, batches):
    """3 train steps with the CLI's optimizer: (losses, step-1 gradients
    from Adam's first moments after that step at learning rate 0, the
    BatchNorm statistics after step 3, K1 and K2 launches)."""
    from avsl_tpu_torch.cli import avhubert_ft
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.objectives import avhubert_ctc_loss_fn, avhubert_seq2seq_loss_fn

    loss_fn = (avhubert_seq2seq_loss_fn if head == "seq2seq" else avhubert_ctc_loss_fn)(
        model, train=True)
    opt = avhubert_ft.make_optimizer(model, 1e-3, 20)
    state, step = TrainState.create(model, opt), make_train_step(loss_fn)
    losses, grads = [], {}

    def run():
        for i, batch in enumerate(batches):
            losses.append(float(step(state, batch)[1]["loss"]))
            if i == 0:
                grads.update({n: mu.detach().float().cpu() / (1.0 - opt.b1)
                              for n, mu in zip(opt.names, opt.mu)})

    _, k1, _, k2 = run_counted(run)
    return losses, grads, _bn_stats(model), (k1, k2)


def phase_small_avhubert_reference(device: str = "cuda"):
    """Tiny AV-HuBERT (encoder 2 heads of 32, decoder 2 heads of 128, every
    rate 0, bf16 compute over fp32 weights), seq2seq and CTC, on the card
    (K1 and K2, the decoder's self-attention causal with key lengths at
    D = 128) against the CPU (plain): eval logits with padded frames and
    both modalities, then 3 train steps with the CLI's optimizer and
    BatchNorm on batch statistics: per-step losses, the step-1 gradients
    and the running statistics after step 3, with the kernels' launches
    counted on the card."""
    from avsl_tpu_torch.train.loop import batch_to_device

    tol = SMALL_AVH_TRAIN_TOL
    for head in ("seq2seq", "ctc"):
        card, cfg = _tiny_avhubert(head, device)
        cpu, _ = _tiny_avhubert(head, "cpu")
        cpu.load_state_dict(card.state_dict())
        batches = _tiny_avhubert_batches(head, cfg.pad_token_id)
        logits, k1_eval = [], []
        for model in (card, cpu):
            b = batch_to_device(batches[0], next(model.parameters()).device)
            kw = dict(audio=b["audio"], video=b["video"], padding_mask=b["padding_mask"])
            if head == "seq2seq":
                kw["decoder_input_ids"] = b["dec_input_ids"]
            with torch.inference_mode():
                out, k1, _, _ = run_counted(lambda: model.eval()(**kw))
            logits.append((out["logits"] if head == "seq2seq" else out).float().cpu())
            k1_eval.append(k1)
        err = (logits[0] - logits[1]).abs()
        logits_ok = bool((err <= SMALL_AVH_LOGITS_TOL["atol"]
                          + SMALL_AVH_LOGITS_TOL["rtol"] * logits[1].abs()).all())
        (l_card, g_card, s_card, launches), (l_cpu, g_cpu, s_cpu, _) = (
            _tiny_avhubert_train(m, head, batches) for m in (card, cpu))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
        names = sorted(g_cpu)
        grad_err = _rel_norm(torch.cat([g_card[n].flatten() for n in names]),
                             torch.cat([g_cpu[n].flatten() for n in names]))
        dec_self = {n: _rel_norm(g_card[n], g_cpu[n]) for n in names
                    if n.startswith("decoder.") and ".self_attn." in n and n.endswith("weight")}
        stats_err = max((s_card[n] - v).abs().max().item() for n, v in s_cpu.items())
        want_eval = cfg.num_hidden_layers + (cfg.decoder_layers if head == "seq2seq" else 0)
        want_train = (3 * want_eval, 3 * want_eval)  # every rate 0: the encoder's is fused too
        log({"phase": "small_avhubert_reference", "head": head,
             "encoder_heads": [cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads],
             "decoder_heads": [cfg.decoder_attention_heads,
                               cfg.decoder_hidden_size // cfg.decoder_attention_heads],
             "logits_max_abs_err": err.max().item(), "logits_tolerance": SMALL_AVH_LOGITS_TOL,
             "losses": {"card": l_card, "cpu": l_cpu}, "loss_max_rel_err": loss_err,
             "step1_grad_rel_norm_err": grad_err, "decoder_self_attn_grad_rel_norm_err": dec_self,
             "batch_stats_max_abs_err": stats_err, "tolerance": tol,
             "k1_eval_launches": k1_eval[0], "train_launches_k1_k2": list(launches)})
        if not logits_ok or not all(math.isfinite(x) for x in l_card):
            raise AssertionError(f"tiny AV-HuBERT {head} card-vs-cpu logits differ by "
                                 f"{err.max().item():.3e}")
        if (loss_err > tol["loss_rtol"] or grad_err > tol["grad_rel_norm"]
                or max(dec_self.values(), default=0.0) > tol["grad_rel_norm"]
                or stats_err > tol["stats_atol"]):
            raise AssertionError(f"tiny AV-HuBERT {head} train card-vs-cpu: loss {loss_err:.3e}, "
                                 f"grads {grad_err:.3e} / {dec_self}, statistics {stats_err:.3e}")
        if k1_eval[0] != want_eval or launches != want_train or k1_eval[1] != 0:
            raise AssertionError(f"tiny AV-HuBERT {head}: K1 eval {k1_eval} != {want_eval}, "
                                 f"train K1/K2 {launches} != {want_train}")


def phase_avhubert_cli(card: str, device: str = "cuda") -> dict:
    """The port's entry point at full width, as a user calls it:
    ``cli.avhubert_ft.main(["--config", configs/avhubert_large.yaml,
    "--steps", "3", "--head", head])`` for both heads (the CLI's synthetic
    batch of 4 items of 24 frames, 3 steps, then the eval forward), each
    printing the CLI's JSON, with the kernels' launches read around the
    call: per step the decoder's 9 self-attentions (the encoder's train
    with attention dropout 0.1, unfused), and in the eval forward the
    encoder's 24 and the decoder's 9."""
    from avsl_tpu_torch.cli import avhubert_ft
    from avsl_tpu_torch.core.config import AVHuBERTConfig

    cfg = AVHuBERTConfig.from_yaml(AVHUBERT_CONFIG)
    out = {}
    for head in ("seq2seq", "ctc"):
        result, k1, stats_writes, k2 = run_counted(lambda: avhubert_ft.main(
            ["--config", AVHUBERT_CONFIG, "--steps", "3", "--head", head, "--device", device]))
        dec = cfg.decoder_layers if head == "seq2seq" else 0
        want = (3 * dec + cfg.num_hidden_layers + dec, 3 * dec)
        log({"phase": "avhubert_cli", "head": head, "card": card, "cli_json": result,
             "k1_launches": k1, "k2_launches": k2, "row_statistics_written": stats_writes,
             "expected_k1_k2": list(want)})
        losses = [result[k] for k in ("first_loss", "last_loss", "eval_loss")]
        if not all(math.isfinite(x) for x in losses) or result["steps"] != 3:
            raise AssertionError(f"cli.avhubert_ft {head}: {result}")
        if (k1, k2) != want or stats_writes != 3 * dec:
            raise AssertionError(f"cli.avhubert_ft {head}: K1 {k1} / K2 {k2} / row statistics "
                                 f"{stats_writes}, expected {want} / {3 * dec}")
        out[head] = (k1, k2)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def prepare_avhubert_batch(cfg, device):
    """An AMI segment batch as the AV-HuBERT path composes it: 8 items of
    10 s of seeded 16 kHz PCM turned into 250 frames of 104-dim features by
    the port's ``avhubert_audio_features`` on the card, 250 seeded 88 x 88
    lip frames, and labels of 20-63
    tokens drawn as ``make_synthetic_av_batchset`` draws them, collated by
    ``collate_av`` with labels cut to 64."""
    from avsl_tpu_torch.cli.avhubert_ft import collate_av
    from avsl_tpu_torch.kernels.fbank import avhubert_audio_features

    rng = np.random.default_rng(11)
    pcm = torch.from_numpy((0.1 * rng.standard_normal((AVH_BATCH, AVH_SAMPLES))).astype(np.float32))
    pcm = pcm.to(device)
    feats = avhubert_audio_features(pcm).cpu().numpy()
    rows = []
    for i in range(AVH_BATCH):
        n_labels = int(rng.integers(AVH_LABELS[0], AVH_LABELS[1] + 1))
        rows.append({"audio_feats": feats[i],
                     "video_feats": rng.standard_normal((feats.shape[1], 88, 88, 1),
                                                        dtype=np.float32),
                     "labels": rng.integers(4, cfg.vocab_size - 1, n_labels).tolist()})
    return collate_av(rows, cfg.pad_token_id, max_label_len=AVH_MAX_LABEL)


def phase_avhubert_train_main_path(card: str, device: str = "cuda") -> dict:
    """AV-HuBERT large seq2seq fine-tuning at full width (the model card's
    rates: dropout, attention dropout 0.1, LayerDrop 0.05 and 0.1, modality
    dropout 0.5; fp32 weights and AdamW state under bf16 compute, the CLI's
    optimizer) on an AMI segment batch (:func:`prepare_avhubert_batch`): 3
    steps with the kernels' launches read around exactly those steps (9 K1
    and 9 K2 a step: the decoder's self-attention, D = 128, causal with key
    lengths), one more step's gradients checked; the eval forward (24 K1
    in the encoder at D = 64 with key lengths, 9 in the decoder); then the
    CTC head: a train step (no kernel) and its eval forward (24 K1)."""
    from avsl_tpu_torch.cli.avhubert_ft import ctc_batch, make_optimizer
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import avhubert_ctc_loss_fn, avhubert_seq2seq_loss_fn

    cfg = AVHuBERTConfig.from_yaml(AVHUBERT_CONFIG)
    batch = prepare_avhubert_batch(cfg, device)
    model = build_avhubert(cfg, "seq2seq", device=device, seed=0)
    count = lambda ps: sum(p.numel() for p in ps)  # noqa: E731
    log({"phase": "build_avhubert_model", "params": count(model.parameters()),
         "decoder_params": count(model.decoder.parameters()), "dtype": cfg.dtype,
         "param_dtype": cfg.param_dtype, "encoder": [cfg.num_hidden_layers, cfg.hidden_size,
                                                     cfg.num_attention_heads],
         "decoder": [cfg.decoder_layers, cfg.decoder_hidden_size, cfg.decoder_attention_heads],
         "fusion": cfg.modality_fuse, "fused_width": cfg.encoder_hidden_size,
         "batch": {k: list(v.shape) for k, v in batch.items()},
         "decoder_lengths": (batch["dec_input_ids"] != cfg.pad_token_id).sum(1).tolist()})
    loss_fn = avhubert_seq2seq_loss_fn(model, train=True)
    opt = make_optimizer(model, 1e-3, 100)
    state, step = TrainState.create(model, opt, seed=0), make_train_step(loss_fn)
    torch.cuda.reset_peak_memory_stats()
    records = []

    def steps():
        for i in range(TRAIN_STEPS):
            _, metrics = step(state, batch)
            records.append({"step": i + 1, "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "label_tokens": int((batch["labels"] >= 0).sum()),
                            "label_len": int(batch["labels"].shape[-1])})

    _, k1, stats_writes, k2 = run_counted(steps)
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * cfg.decoder_layers
    log({"phase": "avhubert_train", "card": card, "steps": records,
         "max_memory_allocated_bytes": peak, "k1_launches": k1, "k2_launches": k2,
         "row_statistics_written": stats_writes, "expected_launches": want})
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"avhubert_train: non-finite loss or grad_norm {records}")
    if (k1, k2, stats_writes) != (want, want, want):
        raise AssertionError(f"avhubert_train: K1 {k1} / K2 {k2} / row statistics "
                             f"{stats_writes} != {want}")

    # one more step's gradients
    loss, _ = loss_fn(batch_to_device(batch, torch.device(device)), state.generator)
    loss.backward()
    # every tensor but mask_emb (no feature mask in fine-tuning) gets a
    # gradient, zero only across a whole layer that LayerDrop dropped or
    # the whole frontend of a stream that modality dropout dropped
    named = {n: p for n, p in model.named_parameters() if not n.endswith("mask_emb")}
    missing = [n for n, p in named.items() if p.grad is None]
    groups: dict = {}
    for n, p in named.items():
        parts = n.split(".")
        cut = parts.index("layers") + 2 if "layers" in parts else (
            3 if parts[2].startswith("feature_extractor_") else len(parts))
        groups.setdefault(".".join(parts[:cut]), []).append(p.grad is not None and bool(p.grad.any()))
    zero = sorted(g for g, nonzero in groups.items() if not any(nonzero))
    partial = sorted(g for g, nonzero in groups.items() if any(nonzero) and not all(nonzero))
    if missing or partial or any(".layers." not in g and "feature_extractor_" not in g
                                 for g in zero):
        raise AssertionError(f"avhubert_train: {len(missing)} tensors got no gradient "
                             f"({missing[:4]}); zero gradients in {zero}, in part of {partial}")
    model.zero_grad(set_to_none=True)
    log({"phase": "avhubert_train_grads_checked", "card": card, "dropped_this_step": zero})

    eval_batch = batch_to_device(batch, torch.device(device))
    model.eval()
    with torch.inference_mode():
        out, e1, e_stats, e2 = run_counted(lambda: model(
            audio=eval_batch["audio"], video=eval_batch["video"],
            decoder_input_ids=eval_batch["dec_input_ids"],
            padding_mask=eval_batch["padding_mask"]))
    want_eval = cfg.num_hidden_layers + cfg.decoder_layers
    log({"phase": "avhubert_eval_forward", "card": card, "k1_launches": e1,
         "k2_launches": e2, "row_statistics_written": e_stats, "expected_k1": want_eval,
         "logits_shape": list(out["logits"].shape)})
    if (e1, e2, e_stats) != (want_eval, 0, 0) or not bool(torch.isfinite(out["logits"]).all()):
        raise AssertionError(f"avhubert eval: K1 {e1} / K2 {e2} / statistics {e_stats}, "
                             f"expected {want_eval} / 0 / 0, or non-finite logits")
    del model, state, opt, loss, out
    gc.collect()
    torch.cuda.empty_cache()

    ctc = build_avhubert(cfg, "ctc", device=device, seed=0)
    cbatch = ctc_batch(batch, cfg.pad_token_id)
    cstate = TrainState.create(ctc, make_optimizer(ctc, 1e-3, 100), seed=0)
    cstep = make_train_step(avhubert_ctc_loss_fn(ctc, train=True))
    (_, metrics), c1, _, c2 = run_counted(lambda: cstep(cstate, cbatch))
    ctc.eval()
    with torch.inference_mode():
        clogits, ce1, _, ce2 = run_counted(lambda: ctc(
            audio=eval_batch["audio"], video=eval_batch["video"],
            padding_mask=eval_batch["padding_mask"]))
    log({"phase": "avhubert_ctc", "card": card, "loss": float(metrics["loss"]),
         "train_k1_k2": [c1, c2], "eval_k1_k2": [ce1, ce2],
         "expected_eval_k1": cfg.num_hidden_layers})
    if (c1, c2, ce1, ce2) != (0, 0, cfg.num_hidden_layers, 0) or not math.isfinite(
            float(metrics["loss"])) or not bool(torch.isfinite(clogits).all()):
        raise AssertionError(f"avhubert_ctc: train K1/K2 {c1}/{c2}, eval {ce1}/{ce2}")
    return {"train": (k1, k2), "eval": (e1, e2), "ctc_eval": (ce1, ce2)}


# the pretraining path (phase 15): masked-cluster pretraining with k-means
# targets, dense and with 8 experts of top 2, at AV-HuBERT large widths
PRETRAIN_CLUSTERS, PRETRAIN_RELABEL_CLUSTERS, PRETRAIN_KMEANS_ITERS = 100, 500, 15
PRETRAIN_LR = 5e-4
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 1.25
# the Switch balance loss is 1 at perfect balance and at most n_experts
MOE_AUX_RANGE = (0.0, float(MOE_EXPERTS))
# k-means card against CPU on separated blobs: fp32 sums in other orders
KMEANS_TOL = 1e-4


def _small_pretrain_batch():
    """4 rows of the pretraining CLI's synthetic frames (12 of 104-dim audio
    features and 48 x 48 lip frames, 4 latent states), cut to 12, 9, 10 and
    11 frames, seeded targets of 8 clusters and a seeded feature mask."""
    from avsl_tpu_torch.cli.pretrain import collate_pretrain, make_synthetic_pretrain_rows

    rows = make_synthetic_pretrain_rows(4, t=12, image=48, seed=5)
    rng = np.random.default_rng(6)
    for row, n in zip(rows, (12, 9, 10, 11)):
        row["audio_feats"], row["video_feats"] = row["audio_feats"][:n], row["video_feats"][:n]
    batch = collate_pretrain(rows, [rng.integers(0, 8, 12) for _ in rows])
    batch["feature_mask"] = (rng.random(batch["padding_mask"].shape) < 0.5) & batch["padding_mask"]
    return batch


def _pretrain_grads(model, batch):
    """One training-mode forward (every rate 0) under the given feature
    mask and its backward: (logits, loss, metrics, gradients by name)."""
    from avsl_tpu_torch.models.intermediates import collect_intermediates
    from avsl_tpu_torch.models.pretrain import extracted_features_from, pretrain_loss
    from avsl_tpu_torch.train.loop import batch_to_device

    b = batch_to_device(batch, next(model.parameters()).device)
    model.train()
    with collect_intermediates() as inter:
        out = model(audio=b["audio"], video=b["video"], targets=b["targets"],
                    padding_mask=b["padding_mask"], feature_mask=b["feature_mask"])
    loss, metrics = pretrain_loss(out, model.cfg, feature_pen=extracted_features_from(inter))
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (out["logits"][0].detach().float().cpu(), float(loss),
            {k: float(v) for k, v in metrics.items()}, grads)


def phase_pretrain_small_reference(card: str, device: str = "cuda") -> tuple:
    """Tiny AV-HuBERT pretraining (encoder 2 heads of 32, every rate 0, bf16
    compute over fp32 weights) on the card (K1 and K2: at attention dropout
    0 the encoder's self-attention is fused in training) against the CPU
    (plain), within SMALL_AVH_TRAIN_TOL: the logits and all the gradients
    together by the relative norm of the difference, the loss relatively,
    under one feature mask; a 4-expert top-2 MoE block's output within
    BF16_TOL and its gradients (all together, the input's and each MoE
    tensor's) by relative norm; and k-means on separated blobs, labels
    equal and centroids within KMEANS_TOL. Returns the card's (K1, K2)."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.data.clustering import kmeans_assign, kmeans_fit
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.models.intermediates import collect_intermediates
    from avsl_tpu_torch.models.layers import TransformerBlock
    from avsl_tpu_torch.models.moe import moe_aux_loss

    tol = SMALL_AVH_TRAIN_TOL
    cfg = AVHuBERTConfig.tiny_test(dtype="bfloat16", **ZERO_AVH_RATES, **SMALL_AVH_OVERRIDES)
    card_model = build_avhubert(cfg, "pretrain", device=device, seed=3, num_classes=(8,))
    cpu_model = build_avhubert(cfg, "pretrain", device="cpu", num_classes=(8,))
    cpu_model.load_state_dict(card_model.state_dict())
    batch = _small_pretrain_batch()
    (l_card, loss_card, m_card, g_card), k1, stats_writes, k2 = run_counted(
        lambda: _pretrain_grads(card_model, batch))
    l_cpu, loss_cpu, m_cpu, g_cpu = _pretrain_grads(cpu_model, batch)
    # the logits are cosines over logit_temp (0.1): held like the gradients,
    # by the relative norm of the difference
    err = (l_card - l_cpu).abs()
    logits_err = _rel_norm(l_card, l_cpu)
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    names = sorted(g_cpu)
    grad_err = _rel_norm(torch.cat([g_card[n].flatten() for n in names]),
                         torch.cat([g_cpu[n].flatten() for n in names]))
    want = (cfg.num_hidden_layers, cfg.num_hidden_layers)
    del card_model, cpu_model

    # a 4-expert top-2 MoE block with key lengths
    def block(device):
        blk = TransformerBlock(cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                               names="fairseq", use_k_bias=True, dtype=torch.bfloat16,
                               param_dtype=torch.float32, device=device, n_experts=4,
                               moe_top_k=2)
        gen = torch.Generator(device=device).manual_seed(7)
        with torch.no_grad():
            for name, prm in blk.named_parameters():
                prm.normal_(0.0, 0.05, generator=gen)
            for mod in blk.modules():
                if isinstance(mod, torch.nn.LayerNorm):
                    mod.weight.fill_(1.0)
        return blk

    card_blk = block(device)
    cpu_blk = block("cpu")
    cpu_blk.load_state_dict(card_blk.state_dict())
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 12, cfg.hidden_size)).astype(np.float32))
    lengths = torch.tensor([12, 9, 10, 11], dtype=torch.int32)

    def moe_run(blk):
        dev = next(blk.parameters()).device
        xin = x.to(dev).requires_grad_(True)
        with collect_intermediates() as inter:
            y, _ = blk(xin, kv_lengths=lengths.to(dev))
            aux = moe_aux_loss(inter)
        ((y.float() ** 2).sum() + 0.01 * aux).backward()
        return (y.detach().float().cpu(), float(aux), xin.grad.float().cpu(),
                {n: p.grad.float().cpu() for n, p in blk.named_parameters()})

    (y_card, aux_card, gx_card, gb_card), mk1, _, mk2 = run_counted(lambda: moe_run(card_blk))
    y_cpu, aux_cpu, gx_cpu, gb_cpu = moe_run(cpu_blk)
    moe_err = float((y_card - y_cpu).abs().max())
    moe_ok = bool(torch.allclose(y_card, y_cpu, **BF16_TOL))
    # all tensors together and the input (the key bias's gradient is zero
    # up to rounding), and each of the MoE's own tensors
    names = sorted(gb_cpu)
    moe_grads = {"all": _rel_norm(torch.cat([gb_card[n].flatten() for n in names]),
                                  torch.cat([gb_cpu[n].flatten() for n in names])),
                 "input": _rel_norm(gx_card, gx_cpu),
                 **{n: _rel_norm(gb_card[n], gb_cpu[n]) for n in names if n.startswith("mlp.")}}
    moe_grad = max(moe_grads.values())
    del card_blk, cpu_blk

    # k-means on 8 separated blobs of 16 dims
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 10
    pts = (centers[rng.integers(0, 8, 4000)]
           + rng.normal(size=(4000, 16)).astype(np.float32))
    c_card, i_card = kmeans_fit(pts, 8, n_iters=PRETRAIN_KMEANS_ITERS, seed=0, device=device)
    c_cpu, i_cpu = kmeans_fit(pts, 8, n_iters=PRETRAIN_KMEANS_ITERS, seed=0, device="cpu")
    labels_equal = bool((kmeans_assign(pts, c_card, device=device)
                         == kmeans_assign(pts, c_cpu, device="cpu")).all())
    c_err = float(np.abs(c_card - c_cpu).max())

    log({"phase": "pretrain_small_reference", "card": card,
         "encoder_heads": [cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads],
         "logits_max_abs_err": err.max().item(), "logits_rel_norm_err": logits_err,
         "loss": {"card": loss_card, "cpu": loss_cpu}, "loss_rel_err": loss_err,
         "metrics": {"card": m_card, "cpu": m_cpu}, "grad_rel_norm_err": grad_err,
         "tolerance": tol, "k1_k2": [k1, k2], "row_statistics_written": stats_writes,
         "expected_k1_k2": list(want),
         "moe_block": {"max_abs_err": moe_err, "within_bf16_tol": moe_ok,
                       "aux": {"card": aux_card, "cpu": aux_cpu},
                       "grad_rel_norm_err": moe_grads, "k1_k2": [mk1, mk2]},
         "kmeans": {"labels_equal": labels_equal, "centroid_max_abs_err": c_err,
                    "inertia": {"card": i_card, "cpu": i_cpu}, "tolerance": KMEANS_TOL}})
    if max(logits_err, grad_err) > tol["grad_rel_norm"] or loss_err > tol["loss_rtol"]:
        raise AssertionError(f"tiny pretraining card-vs-cpu: logits {logits_err:.3e}, "
                             f"loss {loss_err:.3e}, grads {grad_err:.3e}")
    if (k1, k2) != want or stats_writes != k1 or (mk1, mk2) != (1, 1):
        raise AssertionError(f"tiny pretraining: K1/K2 {k1}/{k2} (MoE block {mk1}/{mk2}), "
                             f"expected {want} (1/1)")
    if not moe_ok or moe_grad > tol["grad_rel_norm"] or abs(aux_card - aux_cpu) > 1e-4:
        raise AssertionError(f"MoE block card-vs-cpu: output {moe_err:.3e}, grads "
                             f"{moe_grad:.3e}, aux {aux_card} / {aux_cpu}")
    if not labels_equal or c_err > KMEANS_TOL:
        raise AssertionError(f"k-means card-vs-cpu: labels equal {labels_equal}, centroids "
                             f"{c_err:.3e}")
    return k1 + mk1, k2 + mk2


def _train_pretrain(model, batch, steps: int, name: str) -> tuple:
    """``steps`` train steps of ``avhubert_pretrain_loss_fn`` with the
    CLI's optimizer, launches counted around exactly those steps:
    (records, K1/K2/statistics, peak bytes, last metrics)."""
    from avsl_tpu_torch.cli.avhubert_ft import make_optimizer
    from avsl_tpu_torch.train import TrainState, make_train_step
    from avsl_tpu_torch.train.objectives import avhubert_pretrain_loss_fn

    opt = make_optimizer(model, PRETRAIN_LR, 100)
    state = TrainState.create(model, opt, seed=0)
    step = make_train_step(avhubert_pretrain_loss_fn(model, train=True))
    torch.cuda.reset_peak_memory_stats()
    records, last = [], {}

    def run():
        for i in range(steps):
            _, metrics = step(state, batch)
            vals = {k: float(v) for k, v in metrics.items()}
            records.append({"step": i + 1, **vals})
            last.update(vals)

    _, k1, stats_writes, k2 = run_counted(run)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"{name}: non-finite loss or grad_norm {records}")
    del state, opt
    return records, (k1, k2, stats_writes), peak, last


def _pretrain_eval_and_relabel(model, batch, seen: list, device: str) -> dict:
    """The eval loss (the mask drawn from a generator seeded 42) and the
    relabel tap at the middle layer, each with K1 counted and every launch
    shape recorded: {"eval": (loss, metrics, K1, K2, stats), "relabel":
    (features, K1, K2, stats)}."""
    from avsl_tpu_torch.models.pretrain import extract_layer_features
    from avsl_tpu_torch.train.loop import batch_to_device
    from avsl_tpu_torch.train.objectives import avhubert_pretrain_loss_fn

    dev = batch_to_device(batch, torch.device(device))
    gen = torch.Generator(device=device).manual_seed(42)
    layer = max(1, model.cfg.num_hidden_layers // 2)
    with recorded(True, seen):
        with torch.no_grad():
            (loss, metrics), e1, e_st, e2 = run_counted(
                lambda: avhubert_pretrain_loss_fn(model, train=False)(dev, gen))
        feats, r1, r_st, r2 = run_counted(lambda: extract_layer_features(
            model, layer, audio=dev["audio"], video=dev["video"],
            padding_mask=dev["padding_mask"]))
    return {"eval": (float(loss), {k: float(v) for k, v in metrics.items()}, e1, e2, e_st),
            "relabel": (feats, r1, r2, r_st), "layer": layer}


def phase_pretrain_main_path(card: str, device: str = "cuda") -> tuple:
    """AV-HuBERT large (``configs/avhubert_large.yaml``: bf16 compute, fp32
    weights and AdamW state, the card's rates: attention dropout 0.1 sends
    every encoder self-attention of a train step down the unfused path)
    pretrained on an AMI segment batch (:func:`prepare_avhubert_batch`, 8
    x 10 s): k-means targets (PRETRAIN_CLUSTERS clusters, 15 Lloyd
    iterations on the card over the batch's 2,000 frames of features), 3
    steps of ``avhubert_pretrain_loss_fn`` with the CLI's optimizer (K1 0,
    K2 0); then the eval loss (K1 one a layer), the relabel tap at layer
    12 (K1 12), every K1 launch shape against the plain version, and
    k-means of PRETRAIN_RELABEL_CLUSTERS clusters over the tapped features.
    Returns (counts by path, the batch)."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.data.clustering import kmeans_assign, kmeans_fit
    from avsl_tpu_torch.models import build_avhubert

    cfg = AVHuBERTConfig.from_yaml(AVHUBERT_CONFIG)
    batch = prepare_avhubert_batch(cfg, device)
    frames = torch.from_numpy(batch["audio"]).to(device)[torch.from_numpy(
        batch["padding_mask"]).to(device)]  # [2000, 104], the valid frames
    centroids, inertia = kmeans_fit(frames, PRETRAIN_CLUSTERS, n_iters=PRETRAIN_KMEANS_ITERS,
                                    seed=0, device=device)
    batch["targets"] = kmeans_assign(batch["audio"], centroids, device=device)
    batch = {k: v for k, v in batch.items() if k in ("audio", "video", "padding_mask",
                                                      "targets")}
    model = build_avhubert(cfg, "pretrain", device=device, seed=0,
                           num_classes=(PRETRAIN_CLUSTERS,))
    n_params = sum(p.numel() for p in model.parameters())
    records, (k1, k2, st), peak, last = _train_pretrain(
        model, batch, TRAIN_STEPS, "pretrain_main_path")
    seen: list = []
    ev = _pretrain_eval_and_relabel(model, batch, seen, device)
    feats, r1, r2, r_st = ev["relabel"]
    valid = torch.from_numpy(batch["padding_mask"]).to(device)
    relabel_c, relabel_inertia = kmeans_fit(feats.float()[valid], PRETRAIN_RELABEL_CLUSTERS,
                                            n_iters=PRETRAIN_KMEANS_ITERS, seed=1, device=device)
    del model, feats
    shapes = check_launch_shapes(seen)
    e_loss, e_metrics, e1, e2, e_st = ev["eval"]
    layers = cfg.num_hidden_layers
    rec = {"phase": "pretrain_main_path", "card": card, "config": AVHUBERT_CONFIG,
           "params": n_params, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "batch": {k: list(v.shape) for k, v in batch.items()},
           "clusters": PRETRAIN_CLUSTERS, "kmeans_inertia": inertia, "steps": records,
           "max_memory_allocated_bytes": peak, "train_k1_k2": [k1, k2],
           "last_step": {k: last[k] for k in ("loss", "loss_m", "loss_u", "acc_m", "acc_u",
                                              "features_pen")},
           "eval": {"loss": e_loss, "metrics": e_metrics, "k1_k2": [e1, e2],
                    "expected_k1": layers},
           "relabel": {"layer": ev["layer"], "k1_k2": [r1, r2],
                       "expected_k1": ev["layer"], "kmeans_clusters": PRETRAIN_RELABEL_CLUSTERS,
                       "kmeans_inertia": relabel_inertia,
                       "centroids_shape": list(relabel_c.shape)},
           "shapes_checked": shapes}
    log(rec)
    if (k1, k2, st) != (0, 0, 0):
        raise AssertionError(f"pretrain_main_path: train K1 {k1} / K2 {k2}, expected 0 / 0 "
                             "(attention dropout 0.1 takes the unfused path)")
    if (e1, e2, e_st) != (layers, 0, 0) or (r1, r2, r_st) != (ev["layer"], 0, 0):
        raise AssertionError(f"pretrain_main_path: eval K1 {e1} / K2 {e2}, relabel K1 {r1} / "
                             f"K2 {r2}, expected {layers} and {ev['layer']}")
    if not math.isfinite(e_loss) or not shapes["fwd"]["shapes"] \
            or not np.isfinite(relabel_c).all():
        raise AssertionError(f"pretrain_main_path: eval loss {e_loss}, shapes {shapes}")
    out = {"train": (k1, k2), "eval": (e1, e2), "relabel": (r1, r2)}
    return out, batch


def phase_pretrain_moe(card: str, batch, device: str = "cuda") -> dict:
    """The pretraining model of :func:`phase_pretrain_main_path` with
    MOE_EXPERTS experts of top MOE_TOP_K at capacity MOE_CAPACITY in every
    encoder block (Mixtral's 8 x top-2 over AV-HuBERT large's FFN widths),
    on the same batch: the parameter count, 3 steps (K1 0, K2 0) with the
    balance loss in range, peak memory; then the eval loss and the relabel
    tap with their K1 counts."""
    import dataclasses

    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert

    cfg = dataclasses.replace(AVHuBERTConfig.from_yaml(AVHUBERT_CONFIG), n_experts=MOE_EXPERTS,
                              moe_top_k=MOE_TOP_K, moe_capacity_factor=MOE_CAPACITY)
    model = build_avhubert(cfg, "pretrain", device=device, seed=0,
                           num_classes=(PRETRAIN_CLUSTERS,))
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if n.rsplit(".", 1)[-1] in ("w_in", "b_in", "w_out", "b_out"))
    n_tokens = int(np.prod(batch["padding_mask"].shape))
    capacity = model.encoder.layers[0].mlp.capacity(n_tokens)
    records, (k1, k2, st), peak, last = _train_pretrain(model, batch, TRAIN_STEPS, "pretrain_moe")
    seen: list = []
    ev = _pretrain_eval_and_relabel(model, batch, seen, device)
    _, r1, r2, r_st = ev["relabel"]
    e_loss, e_metrics, e1, e2, e_st = ev["eval"]
    del model
    layers = cfg.num_hidden_layers
    auxes = [r["moe_aux"] for r in records]
    rec = {"phase": "pretrain_moe", "card": card, "experts": MOE_EXPERTS, "top_k": MOE_TOP_K,
           "capacity_factor": MOE_CAPACITY, "capacity": capacity,
           "dispatch_shape": [n_tokens, MOE_EXPERTS, capacity], "params": n_params,
           "expert_params": n_expert, "steps": records, "max_memory_allocated_bytes": peak,
           "train_k1_k2": [k1, k2], "moe_aux": auxes, "last_step": last,
           "eval": {"loss": e_loss, "moe_aux": e_metrics.get("moe_aux"), "k1_k2": [e1, e2]},
           "relabel": {"layer": ev["layer"], "k1_k2": [r1, r2]},
           "shapes_checked": check_launch_shapes(seen)}
    log(rec)
    if (k1, k2, st) != (0, 0, 0) or (e1, e2, e_st) != (layers, 0, 0) \
            or (r1, r2, r_st) != (ev["layer"], 0, 0):
        raise AssertionError(f"pretrain_moe: train K1/K2 {k1}/{k2}, eval {e1}/{e2}, relabel "
                             f"{r1}/{r2}")
    if not all(math.isfinite(a) and MOE_AUX_RANGE[0] < a <= MOE_AUX_RANGE[1] for a in auxes):
        raise AssertionError(f"pretrain_moe: balance loss {auxes} outside {MOE_AUX_RANGE}")
    if not math.isfinite(e_loss):
        raise AssertionError(f"pretrain_moe: eval loss {e_loss}")
    return {"train": (k1, k2), "eval": (e1, e2), "relabel": (r1, r2)}


def phase_pretrain_cli_smoke(card: str, device: str = "cuda") -> dict:
    """The pretraining and fine-tuning entry points with experts on the card,
    as a user calls them: ``cli.pretrain --smoke`` (tiny fp32, attention
    dropout 0.1: the train steps unfused; K1 one a layer in the eval loss),
    then with ``--n_experts 4 --iterations 2`` (two evals and the relabel
    tap at layer 1 over 4 batches); ``cli.avhubert_ft --smoke --n_experts
    4`` for both heads (the seq2seq decoder's self-attention a step, K1 and
    K2, then the eval forward; CTC: K1 in the eval forward only). Returns
    (K1, K2) by run."""
    from avsl_tpu_torch.cli import avhubert_ft, pretrain
    from avsl_tpu_torch.core.config import AVHuBERTConfig

    cfg = AVHuBERTConfig.tiny_test()
    enc, dec, relabel_batches = cfg.num_hidden_layers, cfg.decoder_layers, 4
    runs = {
        "pretrain_cli_smoke": (["--smoke"], (enc, 0)),
        "pretrain_cli_smoke_moe": (["--smoke", "--n_experts", "4", "--iterations", "2"],
                                   (2 * enc + relabel_batches * max(1, enc // 2), 0)),
    }
    out, on = {}, ([] if device == "cuda" else ["--device", device])
    for name, (argv, want) in runs.items():
        result, k1, stats_writes, k2 = run_counted(lambda: pretrain.main(argv + on))
        log({"phase": name, "card": card, "cli_json": result,
             "k1_launches": k1, "k2_launches": k2, "expected_k1_k2": list(want)})
        if (k1, k2, stats_writes) != (*want, 0) or not all(
                math.isfinite(it[k]) for it in result["iterations"] for k in it):
            raise AssertionError(f"cli.pretrain {argv}: K1 {k1} / K2 {k2}, expected {want}: "
                                 f"{result}")
        out[name] = (k1, k2)
    for head in ("seq2seq", "ctc"):
        name = f"avhubert_cli_smoke_moe_{head}"
        result, k1, stats_writes, k2 = run_counted(lambda: avhubert_ft.main(
            ["--smoke", "--n_experts", "4", "--head", head, *on]))
        steps = result["steps"]
        want = ((steps * dec + enc + dec, steps * dec) if head == "seq2seq" else (enc, 0))
        log({"phase": name, "card": card, "cli_json": result,
             "k1_launches": k1, "k2_launches": k2, "expected_k1_k2": list(want)})
        losses = [result[k] for k in ("first_loss", "last_loss", "eval_loss")]
        if (k1, k2) != want or result.get("n_experts") != 4 or not all(
                map(math.isfinite, losses)):
            raise AssertionError(f"cli.avhubert_ft --smoke --n_experts 4 --head {head}: K1 {k1}"
                                 f" / K2 {k2}, expected {want}: {result}")
        out[name] = (k1, k2)
    return out


# the serving daemon (phase 11): the tiny models card against CPU on the
# serving options, then the full-width AV model behind the HTTP daemon
# the daemon's new tokens a batch: 64, cut to 32 to make room for the
# pipeline phase
SERVE_BATCH, SERVE_MAX_NEW, SERVE_WAIT_MS = 8, 32, 30.0
# tiny models, card (K1) against CPU (plain), fp32: scores and the captured
# cross-attention weights within this
SMALL_SERVING_TOL = 1e-4
# the daemon's replies against the transcriber's own on the same items: the
# rows of a batch are computed independently at the fixed batch shape, so
# only a row's place in a bf16 product may move its score
SERVE_LOGPROB_TOL = 1e-3
BOOST_PHRASES = ("meeting", "budget", "quarterly review", "action item", "deadline", "project",
                 "whiteboard", "marketing", "engineering", "schedule", "minutes", "agenda",
                 "remote control", "prototype", "interface", "battery", "design", "customer",
                 "evaluation", "conference")


@contextlib.contextmanager
def seeded_cpu_noise():
    """Within the block, the sampled decode draws its Gumbel noise on the
    CPU from a generator seeded as the one it was given, then moves it to
    the device: the card and the CPU see the same noise."""
    from avsl_tpu_torch.decode import greedy

    original, streams = greedy.gumbel_noise, {}

    def fake(generator, shape, device):
        seed = generator.initial_seed()
        if seed not in streams:
            streams[seed] = torch.Generator().manual_seed(seed)
        return original(streams[seed], shape, "cpu").to(device)

    greedy.gumbel_noise = fake
    try:
        yield
    finally:
        greedy.gumbel_noise = original


def phase_small_serving_reference():
    """The serving options on the tiny Whisper-Flamingo model (fp32, the
    tower at 2 heads of 32, gates 0.5), card against CPU: the temperature
    fallback with the same injected noise (every row retried at both
    temperatures), biased greedy and biased beam search (tokens equal,
    scores within SMALL_SERVING_TOL), the alignment pass's captured
    cross-attention weights (within SMALL_SERVING_TOL) and word boundaries."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.decode.word_timestamps import capture_cross_attention, collect_cross_attention
    from avsl_tpu_torch.infer import StreamingTranscriber
    from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram
    from avsl_tpu_torch.models import build_whisper_flamingo

    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    av_cfg = AVHuBERTConfig.tiny_test(dtype="float32", **SMALL_AV_OVERRIDES)
    models = []
    for device in ("cpu", "cuda"):
        model, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=1,
                                          av_hubert_cfg=av_cfg, dtype="float32", device=device,
                                          seed=5)
        set_gates(model, GATE)
        if models:
            model.load_state_dict(models[0].state_dict())
        models.append(model)
    rng = np.random.default_rng(8)
    items = [{"id": f"s{i}", "audio": (0.2 * rng.standard_normal(int(rng.integers(8000, 16001))))
              .astype(np.float32)} for i in range(4)]
    for i in (0, 2):
        items[i]["lip_feats"] = rng.standard_normal((int(rng.integers(10, 26)), 88, 88, 1),
                                                    dtype=np.float32)
    kw = dict(audio_max_length=16000, video_frames=25, batch_size=4, max_new_tokens=10)
    variants = {
        "fallback": dict(temperature_fallback=(0.5, 1.0), logprob_threshold=0.0),
        "boost_greedy": dict(boost_phrases=["ab", "the", "xyz"]),
        "boost_beam": dict(boost_phrases=["ab", "the", "xyz"], beam_size=3),
        # boosted, so that random weights decode byte tokens that make words
        "word_timestamps": dict(word_timestamps=True, boost_phrases=list(BOOST_PHRASES)),
    }
    rec, worst = {"phase": "small_serving_reference", "tol": SMALL_SERVING_TOL}, 0.0
    for name, opts in variants.items():
        outs = []
        for model in models:
            tr = StreamingTranscriber(model, ByteTokenizer(), **kw, **opts)
            with seeded_cpu_noise():
                outs.append(tr.transcribe(items))
            if name == "fallback" and tr.fallback_decodes != 2:
                raise AssertionError(f"the tiny fallback re-decoded {tr.fallback_decodes} times")
        for want, got in zip(*outs):
            if (got.tokens, got.words) != (want.tokens, want.words):
                raise AssertionError(f"{name}: card tokens or words differ from the CPU's")
            worst = max(worst, abs(got.avg_logprob - want.avg_logprob))
        rec[f"{name}_tokens_equal"] = True
    rec["score_max_abs_err"] = worst
    tok = ByteTokenizer()
    tokens = torch.tensor([tok.sot_sequence("en") + tok.encode(" hello world") + [tok.eot]] * 2)
    audio = torch.from_numpy((0.2 * rng.standard_normal((2, 16000))).astype(np.float32))
    video = torch.from_numpy(rng.standard_normal((2, 25, 88, 88, 1), dtype=np.float32))
    weights = []
    with torch.inference_mode():
        for model in models:
            dev = model.device
            mel = log_mel_spectrogram(audio.to(dev), n_mels=model.cfg.n_mels)
            with capture_cross_attention(model) as captured:
                model(mel, tokens.to(dev), video.to(dev))
            weights.append(collect_cross_attention(captured).float().cpu())
    weight_err = (weights[1] - weights[0]).abs().max().item()
    rec["alignment_weights_shape"] = list(weights[0].shape)
    rec["alignment_weights_max_abs_err"] = weight_err
    log(rec)
    if worst > SMALL_SERVING_TOL or weight_err > SMALL_SERVING_TOL:
        raise AssertionError(f"tiny serving card-vs-cpu: scores {worst:.3e}, "
                             f"weights {weight_err:.3e}")


# the daemon's live stream (30 s before the AV-HuBERT tools' phases: cut
# to make room for them)
STREAM_SECONDS = 10.0
# concurrent requests of the daemon's burst: 16, cut to make room for the
# pipeline phase
DAEMON_REQUESTS = 8


def daemon_items(n: int, n_video: int, seed: int):
    """``n`` requests of exactly 10 s of seeded noise PCM; the first
    ``n_video`` carry 150-250 frames of seeded lip features."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        item = {"id": f"d{i:02d}", "audio": (0.1 * rng.standard_normal(160000)).astype(np.float32)}
        if i < n_video:
            item["lip_feats"] = rng.standard_normal((int(rng.integers(150, 251)), 88, 88, 1),
                                                    dtype=np.float32)
        items.append(item)
    return items


def bursts_with_pauses(seconds: float, burst_s, pause_s: float, seed: int):
    """Seeded noise bursts of ``burst_s`` (lo, hi) seconds separated by
    ``pause_s`` of silence, ``seconds`` long: (pcm, [(pause start, end)]
    in samples)."""
    rng = np.random.default_rng(seed)
    total = int(seconds * 16000)
    pcm = np.zeros(total, np.float32)
    pauses, pos = [], 0
    while pos < total:
        n = int(rng.uniform(*burst_s) * 16000)
        pcm[pos:pos + n] = 0.1 * rng.standard_normal(min(n, total - pos))
        pos += n
        if pos < total:
            pauses.append((pos, min(pos + int(pause_s * 16000), total)))
        pos += int(pause_s * 16000)
    return pcm, pauses


def post_json(address, payload: dict, timeout: float = 600.0):
    """POST ``payload`` to the daemon's /v1/transcribe: (status, reply)."""
    import urllib.error
    import urllib.request

    host, port = address
    req = urllib.request.Request(f"http://{host}:{port}/v1/transcribe",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()}


def phase_serving_daemon(card: str, model, serve_cfg):
    """The daemon's parts (:func:`serving_daemon_parts`) with every
    distinct K1 launch signature they gave recorded, then K1 held against
    its plain version at each of them (the encoder and the tower at every
    batch size the scheduler formed, the alignment pass's causal decoder
    self-attention and gated x_attn, language ID). Returns the parts' K1
    launches."""
    seen = []
    with recorded(True, seen):
        launches = serving_daemon_parts(card, model, serve_cfg)
    log({"phase": "serving_daemon_launch_shapes", "card": card,
         "tolerance": {"bf16": BF16_TOL, "fp32": FP32_TOL}, **check_launch_shapes(seen)})
    return launches


def serving_daemon_parts(card: str, model, serve_cfg):
    """The full-width Whisper-Flamingo model behind the port's HTTP daemon
    (phase 11): ``TranscriptionServer`` on 127.0.0.1, batch 8, 30 ms wait,
    at the JAX CLI's serving shape. (a) DAEMON_REQUESTS (8) concurrent 10
    s requests, 4 audio-only over HTTP with base64 PCM and 4 with lip
    features through
    ``submit``, against the transcriber's own ``transcribe`` on the same
    items; (b) one ``long`` request of 60 s with 0.5 s pauses; (c) a
    ``StreamingSession`` routed through the daemon, STREAM_SECONDS (10 s)
    in 0.32 s chunks;
    (d) the temperature fallback at (0.2, 0.4), (e) word timestamps (with
    the boost, so that random weights decode words), (f) 20 boosted
    phrases, each on 8 of the items, and (g) language ID on 8 clips. K1's launches are gated around (a), (b), (d), (e), (f) and (g)
    to the count the code implies: (32 + 24) a batch, the fallback's
    retries and the alignment pass reusing the batch's encoder outputs,
    the alignment pass's decoder self-attention and gated x_attn 2 x 32, and
    32 for language ID. Every reply must be 200, with no error and no
    rejection, carry its request's id, and give the direct run's text with
    its avg_logprob within SERVE_LOGPROB_TOL. Returns the K1 launches."""
    import threading

    from avsl_tpu_torch.cli._serving_common import serving_video_frames
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.decode.language import detect_language
    from avsl_tpu_torch.infer import StreamingSession, StreamingTranscriber, TranscriptionServer

    cfg, av_cfg = model.cfg, model.video_model.cfg
    per_batch = cfg.n_audio_layer + av_cfg.num_hidden_layers
    audio_max_length = int(serve_cfg.audio_max_length)
    kw = dict(audio_max_length=audio_max_length,
              video_frames=serving_video_frames(audio_max_length), crop=88,
              batch_size=SERVE_BATCH, max_new_tokens=SERVE_MAX_NEW)
    tr = StreamingTranscriber(model, ByteTokenizer(), **kw)
    items = daemon_items(16, 8, seed=3)
    # (a) fires DAEMON_REQUESTS of them, half with lip features
    burst = items[8 - DAEMON_REQUESTS // 2:8 + DAEMON_REQUESTS // 2]
    torch.cuda.reset_peak_memory_stats()
    server = TranscriptionServer(tr, host="127.0.0.1", port=0, max_wait_ms=SERVE_WAIT_MS).start()
    k1 = {}
    rec = {"phase": "serving_daemon", "card": card, "batch": SERVE_BATCH,
           "max_wait_ms": SERVE_WAIT_MS, "max_new_tokens": SERVE_MAX_NEW}

    def gate(name, launches, batches, extra=0):
        want = per_batch * batches + extra
        k1[name] = launches
        if launches != want:
            raise AssertionError(f"serving_daemon {name}: K1 launches {launches} != {want}")

    try:
        # (a) DAEMON_REQUESTS concurrent requests
        replies, pendings = {}, {}

        def http(item):
            replies[item["id"]] = post_json(server.address, {
                "id": item["id"],
                "audio_pcm_b64": base64.b64encode(item["audio"].tobytes()).decode()})

        def fire_all():
            threads = []
            for item in burst:
                if "lip_feats" in item:
                    pendings[item["id"]] = server.submit(dict(item))
                else:
                    threads.append(threading.Thread(target=http, args=(item,)))
                    threads[-1].start()
            for t in threads:
                t.join()
            for p in pendings.values():
                p.done.wait(600)

        before = server.stats.snapshot()
        _, launches, _, _ = run_counted(fire_all)
        snap = server.stats.snapshot()
        batches = snap["n_batches"] - before["n_batches"]
        gate("concurrent", launches, batches)
        bad = [i for i, (s, _) in replies.items() if s != 200]
        bad += [i for i, p in pendings.items() if p.error is not None or p.result is None]
        if bad or len(replies) + len(pendings) != len(burst):
            raise AssertionError(f"serving_daemon: failed requests {bad}")
        wrong_id = [i for i, (_, r) in replies.items() if r.get("id") != i]
        wrong_id += [i for i, p in pendings.items() if p.result.id != i]
        if wrong_id:
            raise AssertionError(f"serving_daemon: replies carry other requests' ids {wrong_id}")
        served = {i: (r["text"], r["avg_logprob"]) for i, (_, r) in replies.items()}
        served.update({i: (p.result.text, p.result.avg_logprob) for i, p in pendings.items()})
        direct, direct_launches, _, _ = run_counted(lambda: tr.transcribe(burst))
        gate("direct", direct_launches, -(-len(burst) // SERVE_BATCH))
        same_text = sum(served[r.id][0] == r.text for r in direct)
        logprob_err = max(abs(served[r.id][1] - r.avg_logprob) for r in direct)
        rec["concurrent"] = {
            "requests": len(burst), "with_video": len(pendings), "batches": batches,
            "batch_occupancy": snap.get("batch_occupancy"),
            "same_text_as_direct": same_text, "avg_logprob_max_abs_err": logprob_err,
            "has_video": sum(p.result.has_video for p in pendings.values())}
        if same_text != len(burst) or logprob_err > SERVE_LOGPROB_TOL:
            raise AssertionError(f"serving_daemon: {same_text} of {len(burst)} texts as the "
                                 f"direct run's, avg_logprob off by {logprob_err:.3e}")

        # (b) one long request: 60 s with 0.5 s pauses
        # bursts of 1-1.5 s: every 2 s search region of the splitter holds a pause
        long_pcm, pauses = bursts_with_pauses(60.0, (1.0, 1.5), 0.5, seed=4)
        before = server.stats.snapshot()
        (status, out), launches, _, _ = run_counted(lambda: post_json(
            server.address, {"id": "long", "long": True,
                             "audio_pcm_b64": base64.b64encode(long_pcm.tobytes()).decode()}))
        if status != 200:
            raise AssertionError(f"serving_daemon long request: {status} {out}")
        segs = out["segments"]
        gate("long", launches, server.stats.snapshot()["n_batches"] - before["n_batches"])
        ends = [s["end_s"] for s in segs]
        tiled = (segs[0]["start_s"] == 0.0 and abs(ends[-1] - len(long_pcm) / 16000) < 1e-3
                 and all(abs(e - s["start_s"]) < 1e-6 for e, s in zip(ends, segs[1:])))
        at_pauses = all(any(p0 / 16000 - 2e-3 <= e <= p1 / 16000 + 2e-3 for p0, p1 in pauses)
                        for e in ends[:-1])
        longest = max(s["end_s"] - s["start_s"] for s in segs)
        rec["long"] = {"seconds_of_audio": len(long_pcm) / 16000, "windows": len(segs),
                       "tiled": tiled, "cuts_in_pauses": at_pauses, "longest_window_s": longest}
        if not (tiled and at_pauses and longest <= audio_max_length / 16000 + 1e-3):
            raise AssertionError(f"serving_daemon long segments: {rec['long']}")

        # (c) a live stream routed through the daemon
        def via_server(its):
            ps = [server.submit(it) for it in its]
            for p in ps:
                p.done.wait(600)
            if any(p is None or p.error is not None for p in ps):
                raise AssertionError("serving_daemon: a streamed utterance failed")
            return [p.result for p in ps]

        stream_pcm, _ = bursts_with_pauses(STREAM_SECONDS, (5.0, 7.0), 0.6, seed=5)
        sess = StreamingSession(tr, stream_id="live", transcribe_fn=via_server)
        stream_segs, chunk = [], 5120  # 0.32 s
        for i in range(0, len(stream_pcm), chunk):
            stream_segs += sess.feed(stream_pcm[i:i + chunk])
        stream_segs += sess.flush()
        ordered = all(a.end_s <= b.start_s + 1e-6 for a, b in zip(stream_segs, stream_segs[1:]))
        rec["streaming"] = {"seconds_of_audio": STREAM_SECONDS, "chunk_s": 0.32,
                            "utterances": len(stream_segs), "ordered": ordered,
                            "spans": [[s.start_s, s.end_s] for s in stream_segs]}
        if not stream_segs or not ordered:
            raise AssertionError(f"serving_daemon streaming: {rec['streaming']}")
        final = server.stats.snapshot()
        rec["stats"] = final
    finally:
        server.stop()
    if final["n_errors"] or final["n_rejected"]:
        raise AssertionError(f"serving_daemon: {final['n_errors']} errors, "
                             f"{final['n_rejected']} rejected")

    # (d)-(f): the serving options on one batch each, beside the plain batch
    batch_items = items[:SERVE_BATCH]
    plain, launches, _, _ = run_counted(lambda: tr.transcribe_batch(batch_items))
    gate("plain_batch", launches, 1)
    eot = ByteTokenizer().eot
    rec["plain_batch_decoded_tokens"] = decoded_tokens(plain, eot, SERVE_MAX_NEW)
    options = {
        "fallback": dict(temperature_fallback=(0.2, 0.4)),
        # boosted, so that random weights decode byte tokens that make words
        "word_timestamps": dict(word_timestamps=True, boost_phrases=list(BOOST_PHRASES)),
        "boost": dict(boost_phrases=list(BOOST_PHRASES)),
    }
    for name, opts in options.items():
        otr = StreamingTranscriber(model, ByteTokenizer(), **kw, **opts)
        results, launches, _, _ = run_counted(lambda: otr.transcribe_batch(batch_items))
        check_served(results, SERVE_BATCH, SERVE_MAX_NEW)
        sub = {"decoded_tokens": decoded_tokens(results, eot, SERVE_MAX_NEW),
               "tokens_differ_from_plain": sum(r.tokens != p.tokens for r, p in zip(results, plain))}
        if name == "fallback":
            gate(name, launches, 1)
            sub["sampled_decodes"] = otr.fallback_decodes
            if otr.fallback_decodes != 2:  # random weights: every row retries at both
                raise AssertionError(f"the fallback re-decoded {otr.fallback_decodes} times, not 2")
        elif name == "word_timestamps":
            gate(name, launches, 1, extra=2 * cfg.n_text_layer)
            sub["words"] = sum(len(r.words) for r in results)
            if not sub["words"]:
                raise AssertionError("serving_daemon: the alignment pass gave no words")
            for r, it in zip(results, batch_items):
                window = min(len(it["audio"]), audio_max_length) / 16000
                starts = [w["start_s"] for w in r.words]
                if starts != sorted(starts) or any(
                        not 0.0 <= w["start_s"] <= w["end_s"] <= window + 0.02 for w in r.words):
                    raise AssertionError(f"serving_daemon words of {r.id} outside its window "
                                         f"or out of order")
        else:
            gate(name, launches, 1)
            trie = otr._biasing
            if trie.next_node.device != model.device:
                raise AssertionError("the biasing trie is not on the model's card")
            sub.update(phrases=len(BOOST_PHRASES), trie_nodes=trie.n_nodes, vocab=cfg.n_vocab,
                       trie_table_bytes=trie.n_nodes * cfg.n_vocab * 4, trie_bytes=trie.nbytes)
        rec[name] = sub

    # (g) language ID on 8 clips
    clips = np.stack([it["audio"][:audio_max_length] for it in batch_items])
    dets, launches, _, _ = run_counted(lambda: detect_language(model, ByteTokenizer(), clips))
    gate("language", launches, 0, extra=cfg.n_audio_layer)
    sums = [sum(table.values()) for _, table in dets]
    rec["language"] = {"clips": len(dets), "best": [b for b, _ in dets],
                       "max_sum_err": max(abs(s - 1.0) for s in sums)}
    if rec["language"]["max_sum_err"] > 1e-4:
        raise AssertionError(f"language posteriors do not sum to 1: {sums}")
    rec["k1_launches"] = k1
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(rec)
    return sum(v for k, v in k1.items() if k != "direct")


# serving_extras (item 11's second half): int8 weights and cache on the AV
# model, speculative decoding and the exported programs on the audio-only
# large-v2 target
EXTRAS_BATCH, EXTRAS_MAX_NEW = 8, 64
# new tokens a batch of the int8 phase: EXTRAS_MAX_NEW, cut to make room for
# the pipeline phase
INT8_MAX_NEW = 32
SPEC_K = 4
# a row may leave plain greedy only where the target's top two logits are
# nearer than the bf16 tolerance: the verify pass runs (k+1)-row products,
# greedy 1-row ones, and bf16 products of other shapes round differently
NEAR_TIE = BF16_TOL["atol"]
EXPORT_LOGPROB_TOL = 1e-3


def run_each(runs: dict, k1: dict) -> dict:
    """Each of ``runs`` (name -> a function that runs one batch) once, its
    K1 launches gated to ``k1``'s count for its name, with no row
    statistics and no K2. Returns per name the K1 launches, the run's
    peak device memory and its output."""
    out = {}
    for name, fn in runs.items():
        torch.cuda.reset_peak_memory_stats()
        result, launches, stats_writes, k2 = run_counted(fn)
        if stats_writes or k2 or launches != k1[name]:
            raise AssertionError(f"{name}: {launches} K1 launches ({stats_writes} with "
                                 f"statistics, {k2} K2) != {k1[name]}")
        out[name] = {"k1": launches, "peak_bytes": torch.cuda.max_memory_allocated(),
                     "result": result}
    return out


def check_int8_against_cpu(model, qmodel) -> dict:
    """Every int8 weight of ``qmodel`` (quantized on the card from
    ``model``'s weights) bit-equal to the CPU's quantization of the same
    values."""
    from avsl_tpu_torch.models.quant import channel_axis, quantize_array, quantized_weights

    params = dict(model.named_parameters())
    n = elems = 0
    for name, qt in quantized_weights(qmodel).items():
        want = quantize_array(params[name].detach().float().cpu(), channel_axis(name))
        if not (torch.equal(qt.q.cpu(), want.q) and torch.equal(qt.scale.cpu(), want.scale)):
            raise AssertionError(f"{name}: the card's int8 weight differs from the CPU's")
        n, elems = n + 1, elems + qt.q.numel()
    return {"tensors_bit_equal": n, "elements": elems}


def small_int8_reference() -> dict:
    """The tiny Whisper-Flamingo model (fp32, the tower at 2 heads of 32,
    gates 0.5) served with int8 weights and the int8 cache, card against
    CPU: the same int8 weights, equal tokens, scores within
    SMALL_SERVING_TOL."""
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber
    from avsl_tpu_torch.models import build_whisper_flamingo
    from avsl_tpu_torch.models.quant import quantized_weights

    vocab = ByteTokenizer().add_tokens(["<laugh>"])
    av_cfg = AVHuBERTConfig.tiny_test(dtype="float32", **SMALL_AV_OVERRIDES)
    rng = np.random.default_rng(12)
    items = [{"id": f"q{i}", "audio": (0.2 * rng.standard_normal(int(rng.integers(8000, 16001))))
              .astype(np.float32)} for i in range(4)]
    items[1]["lip_feats"] = rng.standard_normal((20, 88, 88, 1), dtype=np.float32)
    outs, weights = [], []
    # the batch output's scores, unrounded (a result's avg_logprob is
    # rounded to 4 decimals, which can put 1e-6 apart a rounding step apart)
    for device in ("cpu", "cuda"):
        model, _ = build_whisper_flamingo("test", vocab_size=vocab, add_gated_x_attn=1,
                                          av_hubert_cfg=av_cfg, dtype="float32", device="cpu",
                                          seed=6)
        set_gates(model, GATE)
        tr = StreamingTranscriber(model.to(device), ByteTokenizer(), audio_max_length=16000,
                                  video_frames=25, batch_size=4, max_new_tokens=10,
                                  quantize="int8", kv_int8=True)
        weights.append({k: (v.q.cpu(), v.scale.cpu())
                        for k, v in quantized_weights(tr.model).items()})
        outs.append(tr.run_batch(tr._prepare_batch(items)))
    if any(not (torch.equal(weights[0][k][0], weights[1][k][0])
                and torch.equal(weights[0][k][1], weights[1][k][1])) for k in weights[0]):
        raise AssertionError("the tiny model's int8 weights differ card against CPU")
    if not (outs[0].tokens == outs[1].tokens).all():
        raise AssertionError("the tiny int8 model's card tokens differ from the CPU's")
    worst = float(np.abs(outs[0].scores - outs[1].scores).max())
    if worst > SMALL_SERVING_TOL:
        raise AssertionError(f"the tiny int8 model's scores differ by {worst:.3e}")
    return {"int8_tensors": len(weights[0]), "tokens_equal": True, "score_max_abs_err": worst}


def phase_serving_extras_int8(card: str, holder: list) -> dict:
    """int8 weights and the int8 cache on the JAX CLI's default AV model
    (``holder`` = [model, serve config], emptied here): the int8 copy,
    gated bit-equal to the CPU's quantization of the same weights; then
    one batch of 8 items of 10 s (6 with lip features), INT8_MAX_NEW (32)
    new tokens, greedy, in bf16, ``kv_int8``, ``quantize="int8"`` and
    both, exactly 56 K1 a batch; then the float model freed, the resident
    bytes read, and the int8 model's peak over one more batch without it.
    Returns K1 launches by variant."""
    from avsl_tpu_torch.cli._serving_common import serving_video_frames
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.models.quant import quantization_report, tree_bytes

    model, serve_cfg = holder
    holder.clear()
    rec = {"phase": "serving_extras_int8", "card": card, "small": small_int8_reference()}
    audio_max_length = int(serve_cfg.audio_max_length)
    kw = dict(audio_max_length=audio_max_length,
              video_frames=serving_video_frames(audio_max_length), crop=88,
              batch_size=EXTRAS_BATCH, max_new_tokens=INT8_MAX_NEW)
    per_batch = model.cfg.n_audio_layer + model.video_model.cfg.num_hidden_layers
    int8 = StreamingTranscriber(model, ByteTokenizer(), quantize="int8", **kw)
    rec["quantization_report"] = quantization_report(model, int8.model)
    rec["bit_equal_to_cpu"] = check_int8_against_cpu(model, int8.model)
    rec["float_model_bytes"] = tree_bytes(model)
    rec["int8_model_bytes"] = tree_bytes(int8.model)
    int8_kv = StreamingTranscriber(int8.model, ByteTokenizer(), kv_int8=True, **kw)
    trs = {"bf16": StreamingTranscriber(model, ByteTokenizer(), **kw),
           "kv_int8": StreamingTranscriber(model, ByteTokenizer(), kv_int8=True, **kw),
           "int8": int8, "int8_kv_int8": int8_kv}
    prep = trs["bf16"]._prepare_batch(av_items(EXTRAS_BATCH, seed=3))
    runs = run_each({name: (lambda tr=tr: tr.run_batch(prep)) for name, tr in trs.items()},
                    dict.fromkeys(trs, per_batch))
    base = runs["bf16"]["result"].tokens
    variants = {name: {"k1_per_batch": r["k1"],
                       "tokens_equal_to_bf16": float((r["result"].tokens == base).mean())}
                for name, r in runs.items()}
    # the float model and the int8 copy are both resident through the runs
    rec["peak_bytes_both_models"] = max(r["peak_bytes"] for r in runs.values())
    del trs, runs, model
    gc.collect()
    torch.cuda.empty_cache()
    rec["resident_bytes_float_freed"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    int8_kv.run_batch(prep)
    rec["peak_bytes_int8_kv_int8_float_freed"] = torch.cuda.max_memory_allocated()
    rec["variants"] = variants
    log(rec)
    return {name: v["k1_per_batch"] for name, v in variants.items()}


@contextlib.contextmanager
def spec_probe(k: int):
    """Within the block, count the transcriber's draft and target forwards
    in speculative decoding and record, for every verify pass and row, the
    first draft token the target rejects with the target's gap there
    (its top logit less the draft token's, fp32). Adds host reads: for
    counts, not for timing."""
    from avsl_tpu_torch.infer import pipeline

    original = pipeline.speculative_greedy_decode
    probe = {"draft_forwards": 0, "target_forwards": 0, "rejection_gaps": []}

    def wrapped(target_step, draft_step, tc, dc, prompt, max_new, eot, k=k):
        def t_step(tok, c):
            logits, c = target_step(tok, c)
            probe["target_forwards"] += 1
            if tok.shape[1] == k + 1:  # a verify pass over [y, d_1..d_k]
                lp = logits.float()
                top = lp.argmax(-1)[:, :k]
                drafted = tok[:, 1:]
                miss = (drafted != top).cpu().numpy()
                gaps = (lp[:, :k].gather(-1, top[..., None]) - lp[:, :k].gather(
                    -1, drafted[..., None]))[..., 0].cpu().numpy()
                for row in range(miss.shape[0]):
                    if miss[row].any():
                        probe["rejection_gaps"].append(float(gaps[row, miss[row].argmax()]))
            return logits, c

        def d_step(tok, c):
            probe["draft_forwards"] += 1
            return draft_step(tok, c)

        return original(t_step, d_step, tc, dc, prompt, max_new, eot, k=k)

    pipeline.speculative_greedy_decode = wrapped
    try:
        yield probe
    finally:
        pipeline.speculative_greedy_decode = original


def greedy_with_gaps(tr, prep):
    """Plain greedy tokens of one prepared batch with the target's top-2
    logit gap (fp32) at every step, [B, max_new]."""
    from avsl_tpu_torch.decode.greedy import greedy_decode

    gaps = []
    model = tr.model

    def step(tok, c):
        logits, c = model.decode(tok, None, None, c)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        return logits, c

    with torch.inference_mode(), tr.serving_mode():
        x = torch.from_numpy(prep.audio).cuda()
        feats, xv = tr.encode(x, prep.video)
        tokens = greedy_decode(step, tr.decode_cache(feats, xv, tr.cache_len()), tr._prompt,
                               tr.max_new_tokens, tr.tokenizer.eot)
    return tokens.cpu().numpy(), torch.stack(gaps, dim=1).cpu().numpy()


def near_tie_rows(tokens, ref_tokens, ref_gaps) -> list:
    """Rows of ``tokens`` that differ from plain greedy's, each with its
    first differing step and greedy's top-2 gap there; raises for a row
    whose gap is not a near-tie."""
    rows = []
    for r in np.nonzero((tokens != ref_tokens).any(axis=1))[0]:
        i = int(np.argmax(tokens[r] != ref_tokens[r]))
        gap = float(ref_gaps[r, i])
        if gap >= NEAR_TIE:
            raise AssertionError(f"row {r} leaves greedy at step {i} where the top-2 gap is "
                                 f"{gap:.4f} >= {NEAR_TIE}")
        rows.append({"row": int(r), "step": i, "gap": gap})
    return rows


def phase_serving_extras_spec(card: str, model) -> dict:
    """Speculative decoding on the audio-only large-v2 target of the main
    path (30 s windows, batch 8, 64 new tokens, spec_k 4), with (a) a
    random ``tiny`` draft at its published widths (384 wide, 6 heads, 4
    layers), written by ``save_checkpoint`` and read back through the
    serving CLIs' ``--draft_ckpt`` path, and (b) the target as its own
    draft; against plain greedy on the same batch. Gates: K1 exactly 32 +
    4 and 32 + 32 a batch; both give greedy's tokens but at near-ties;
    (b) accepts every draft token in ceil(64 / 5) = 13 rounds, but at
    near-tie rejections. Every K1 launch shape is held against the plain
    version. Returns K1 launches by draft."""
    import argparse

    from avsl_tpu_torch.cli._serving_common import build_draft
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.models import build_whisper_flamingo
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.loop import TrainState

    vocab = model.cfg.n_vocab
    with tempfile.TemporaryDirectory() as ckpt:
        saved, _ = build_whisper_flamingo("tiny", vocab_size=vocab, add_gated_x_attn=0,
                                          use_av_hubert_encoder=False, dtype="bfloat16",
                                          device="cuda", seed=11)
        save_checkpoint(ckpt, TrainState.create(saved, None), 1)
        del saved
        args = argparse.Namespace(draft_model="tiny", draft_ckpt=ckpt, spec_k=SPEC_K, beam=1,
                                  device="cuda")
        tiny, tiny_weights = build_draft(args, vocab, smoke=False)
    rng = np.random.default_rng(14)
    items = [{"id": f"sp{i}", "audio": (0.1 * rng.standard_normal(int(rng.integers(
        320000, 480001)))).astype(np.float32)} for i in range(EXTRAS_BATCH)]
    kw = dict(audio_max_length=480000, batch_size=EXTRAS_BATCH, max_new_tokens=EXTRAS_MAX_NEW)
    n_layer = model.cfg.n_audio_layer
    trs = {"plain": StreamingTranscriber(model, ByteTokenizer(), **kw),
           "tiny_draft": StreamingTranscriber(model, ByteTokenizer(), draft_model=tiny,
                                              draft_variables=tiny_weights, spec_k=SPEC_K, **kw),
           "self_draft": StreamingTranscriber(model, ByteTokenizer(), draft_model=model,
                                              spec_k=SPEC_K, **kw)}
    k1 = {"plain": n_layer, "tiny_draft": n_layer + tiny.cfg.n_audio_layer,
          "self_draft": 2 * n_layer}
    prep = trs["plain"]._prepare_batch(items)
    ref_tokens, ref_gaps = greedy_with_gaps(trs["plain"], prep)
    seen = []
    with recorded(True, seen):
        runs = run_each({name: (lambda tr=tr: tr._run(prep.audio, prep.video))
                         for name, tr in trs.items()}, k1)
    if not (runs["plain"]["result"].tokens == ref_tokens).all():
        raise AssertionError("plain greedy's tokens are off the reference decode")
    rec = {"phase": "serving_extras_speculative", "card": card, "spec_k": SPEC_K,
           "near_tie": NEAR_TIE, "plain_min_top2_gap": float(ref_gaps.min()),
           "draft_tiny": {"widths": [tiny.cfg.n_audio_state, tiny.cfg.n_audio_head,
                                     tiny.cfg.n_audio_layer],
                          "params": sum(p.numel() for p in tiny.parameters())}}
    for name in ("tiny_draft", "self_draft"):
        tr, r = trs[name], runs[name]
        stats = tr.spec_stats()
        with spec_probe(SPEC_K) as probe:
            probed = tr._run(prep.audio, prep.video)
        tokens = r["result"].tokens
        if not (probed.tokens == tokens).all():
            raise AssertionError(f"{name}: the probed run's tokens differ from the counted run's")
        v = {"k1_per_batch": r["k1"], "spec_stats": stats, "rounds": stats["mean_verify_rounds"],
             "accept_rate": stats["mean_accept_rate"],
             "draft_forwards": probe["draft_forwards"],
             "target_forwards": probe["target_forwards"],
             "rejections": len(probe["rejection_gaps"]),
             "near_tie_rows": near_tie_rows(tokens, ref_tokens, ref_gaps)}
        if name == "self_draft":
            ties = [g for g in probe["rejection_gaps"] if g < NEAR_TIE]
            v["near_tie_rejections"] = len(ties)
            if len(ties) != len(probe["rejection_gaps"]):
                raise AssertionError(f"self draft rejected tokens at gaps "
                                     f"{sorted(probe['rejection_gaps'])[-3:]} >= {NEAR_TIE}")
            if not ties and (v["accept_rate"] != 1.0 or v["rounds"] != math.ceil(
                    EXTRAS_MAX_NEW / (SPEC_K + 1))):
                raise AssertionError(f"self draft: accept {v['accept_rate']}, rounds "
                                     f"{v['rounds']} without a near-tie rejection")
        rec[name] = v
    launches = {name: runs[name]["k1"] for name in ("tiny_draft", "self_draft")}
    rec["shapes_checked"] = check_launch_shapes(seen)
    log(rec)
    return launches


def write_published_size_vocab(path: str) -> None:
    """A byte-level BPE vocabulary (``vocab.json`` + ``merges.txt``) whose
    tokenizer has large-v2's 51,865 ids, specials included: the 256 byte
    symbols and merges of symbol pairs up to that size. Served through a
    config's ``download_root``, it sizes the model's embedding and logits
    as the published vocabulary does (the special ids sit above the merges,
    not at the published values)."""
    from avsl_tpu_torch.data.tokenizer import BPETokenizer, bytes_to_unicode

    symbols = sorted(bytes_to_unicode().values())
    n_merges = LARGE_V2_VOCAB - 1 - BPETokenizer({}, []).vocab_size - len(symbols)
    merges = [(a, b) for a in symbols for b in symbols][:n_merges]
    vocab = {ch: i for i, ch in enumerate(symbols)}
    vocab.update({a + b: len(symbols) + i for i, (a, b) in enumerate(merges)})
    BPETokenizer(vocab, merges).save(path)


def phase_serving_extras_export(card: str) -> int:
    """The audio-only large-v2 transcriber (30 s windows, batch 8, 64 new
    tokens, the published vocabulary's size through
    :func:`write_published_size_vocab`) exported through
    ``cli/export_program --platforms cuda`` from
    a checkpoint of seeded random weights, into a temporary directory that
    is deleted afterwards; its programs loaded with ``load_exported`` and
    replayed against the live transcriber on the same weights. Gates: the
    replay's tokens equal the live run's, avg_logprob within
    EXPORT_LOGPROB_TOL, 32 K1 launches a replayed batch by the wrapper's
    count and by the profiler's kernels. Returns the replay's K1
    launches."""
    import yaml

    from avsl_tpu_torch.cli import export_program
    from avsl_tpu_torch.cli._serving_common import build_target_model
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber, load_exported
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.loop import TrainState
    from torch.profiler import ProfilerActivity, profile

    vocab = tempfile.TemporaryDirectory()
    vocab_dir = vocab.name
    write_published_size_vocab(vocab_dir)
    fields = dict(model_name="large-v2", add_gated_x_attn=0, use_av_hubert_encoder=False,
                  audio_max_length=480000, download_root=vocab_dir)
    cfg = FlamingoTrainConfig(**fields)
    tokenizer = get_tokenizer(vocab_dir, cfg.lang)
    model, w_cfg = build_target_model(cfg, tokenizer, False, None, device="cuda", seed=7)
    if w_cfg.n_vocab != LARGE_V2_VOCAB:
        raise AssertionError(f"export: n_vocab {w_cfg.n_vocab} != {LARGE_V2_VOCAB}")
    live = StreamingTranscriber(model, tokenizer, audio_max_length=480000,
                                batch_size=EXTRAS_BATCH, max_new_tokens=EXTRAS_MAX_NEW)
    rng = np.random.default_rng(15)
    prep = live._prepare_batch([{"id": f"ex{i}", "audio": (0.1 * rng.standard_normal(
        int(rng.integers(320000, 480001)))).astype(np.float32)} for i in range(EXTRAS_BATCH)])
    rec = {"phase": "serving_extras_export", "card": card, "model": w_cfg.name,
           "n_vocab": w_cfg.n_vocab}
    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/serve.yaml", "w") as f:
            yaml.safe_dump(fields, f)
        save_checkpoint(f"{d}/ckpt", TrainState.create(model, None), 1)
        manifest = export_program.main(["--config", f"{d}/serve.yaml", "--ckpt_dir", f"{d}/ckpt",
                                        "--output", f"{d}/program", "--platforms", "cuda",
                                        "--batch_size", str(EXTRAS_BATCH),
                                        "--max_new_tokens", str(EXTRAS_MAX_NEW)])
        rec["artifact_bytes"] = manifest["bytes"]
        gc.collect()
        torch.cuda.empty_cache()
        call, _ = load_exported(f"{d}/program")
    vocab.cleanup()
    audio = torch.from_numpy(prep.audio).cuda()
    video = torch.from_numpy(prep.video).cuda()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(audio, video, live._prompt)
        torch.cuda.synchronize()
    layers = w_cfg.n_audio_layer
    runs = run_each({"live": lambda: live._run(prep.audio, prep.video),
                     "replay": lambda: call(audio, video, live._prompt)},
                    {"live": layers, "replay": layers})
    want, got = runs["live"]["result"], runs["replay"]["result"]
    traced_k1 = sum(1 for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and "flash_fwd" in e.name())
    tokens, scores = got[0].cpu().numpy(), got[1].cpu().numpy()
    err = float(np.abs(scores - want.scores).max())
    rec.update(replay_k1=runs["replay"]["k1"], profiler_k1=traced_k1,
               tokens_equal=bool((tokens == want.tokens).all()),
               avg_logprob_max_abs_err=err, manifest={k: manifest[k] for k in (
                   "format", "platforms", "inputs", "quantize", "kv_int8", "speculative")})
    log(rec)
    if traced_k1 != layers:
        raise AssertionError(f"replay: {traced_k1} K1 kernels traced != {layers}")
    if not rec["tokens_equal"] or err > EXPORT_LOGPROB_TOL:
        raise AssertionError(f"replay differs from the live run: avg_logprob by {err:.3e}")
    return runs["replay"]["k1"]


# the training extras (LoRA, EMA, remat, distillation)
LORA_RANK, LORA_ALPHA, LORA_EMA = 8, 16.0, 0.999
# depths cut to make room for the pretraining path (were 3 steps, 4
# micro-batches a remat step and 100 distillation steps)
LORA_STEPS = 2
# the LoRA phase's accumulation (PATH_ACCUM until the sequence-parallel and
# serving-mesh phases came, cut to make room for them, then 4 -> 2 for the
# expert-parallel ones)
LORA_ACCUM = 2
REMAT_AB_ACCUM, REMAT_AB_STEPS = 2, 2
# distillation steps: 100, cut to 50 and then to 25 to make room for the serving mesh
DISTILL_CLIPS, DISTILL_STEPS, DISTILL_LR = 32, 25, 1e-3


def lora_job_config(out_dir: str, vocab_dir: str) -> str:
    """The training YAML with ``lora_rank`` 8, ``lora_alpha`` 16,
    ``ema_decay`` 0.999, LORA_STEPS optimizer steps validated once at the end, the
    published vocabulary's size (:func:`write_published_size_vocab`, so that
    ``cli.export_lora`` and ``cli.transcribe`` build the same model from it)
    and its outputs under ``out_dir``; written there, its path returned."""
    import os

    import yaml

    with open(TRAIN_CONFIG) as f:
        fields = yaml.safe_load(f)
    accum = fields["gradient_accumulation_steps"] = LORA_ACCUM
    fields.update(lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA, ema_decay=LORA_EMA,
                  num_train_steps=LORA_STEPS, validate_every_n_batches=LORA_STEPS * accum,
                  num_sanity_val_steps=0, download_root=vocab_dir,
                  log_output_dir=os.path.join(out_dir, "lora_logs"),
                  check_output_dir=os.path.join(out_dir, "lora_ckpt"))
    path = os.path.join(out_dir, "lora.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(fields, f)
    return path


class SeededLipFrames:
    """A dataset's items, each with seeded lip frames in place of the one
    zero frame a row without a clip gets: ``round(audio_frames / 4)``
    frames (25 fps) of U[0, 1) grey levels, normalised as a clip is. An
    all-zero tower input puts every LayerNorm of the untrained tower at
    zero variance, a gain of 1/sqrt(eps) = 316 on the gradient each, and
    LoRA's backward through 24 pre-norm blocks overflows (ROADMAP.md §3);
    lip frames are what an AV LoRA run trains on."""

    def __init__(self, ds, seed: int, crop: int = 88):
        self.ds, self.seed, self.crop = ds, seed, crop

    def __len__(self) -> int:
        return len(self.ds)

    def audio_length(self, idx: int) -> int:
        return self.ds.audio_length(idx)

    def __getitem__(self, idx: int):
        item = self.ds[idx]
        frames = max(1, int(round(item["audio_frames"] / 4)))
        rng = np.random.default_rng((self.seed, idx))
        grey = rng.random((frames, self.crop, self.crop, 1), dtype=np.float32)
        item["video"] = (grey - 0.421) / 0.165
        return item


def phase_flamingo_lora_train(card: str, out_dir: str):
    """LoRA fine-tuning of the full-width Whisper-Flamingo model through
    ``cli.finetune.make_job`` and ``run`` on the training YAML (large-v2 +
    AV-HuBERT large, remat on as the YAML sets it) with rank-8 adapters on
    every q/v projection (encoder, decoder self/cross/x_attn, the tower),
    EMA 0.999, gates 0.5, on the dataset phase's seeded rows with seeded
    lip frames (:class:`SeededLipFrames`): LORA_STEPS (2) optimizer
    steps of 16 bucketed micro-batches under MultiSteps, validation and
    ``test_best``. Then ``cli.export_lora`` writes the merged checkpoint
    (onto the base saved as ``--base_ckpt``: its gates are 0.5),
    the serving model loaded from it gives the LoRA model's logits, and
    ``cli.transcribe --ckpt_dir`` serves 8 items from it. Gates: every base
    tensor bit-identical; every adapter's B non-zero; ``best/`` holds the
    EMA, not the raw adapters; merged logits within BF16_TOL; K1 and K2
    launches exactly (32 x 2 + 96) and (32 + 96) a micro-step (the
    encoder's remat recomputes its K1) and 152 K1 an eval batch; K1 and
    K2 against the plain version at every distinct launch shape. Returns
    the job (for ``remat_ab``) and the launches."""
    import collections
    import os
    import shutil

    from avsl_tpu_torch.cli import export_lora, finetune, transcribe
    from avsl_tpu_torch.cli._serving_common import build_target_with_weights
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.audio_segments import write_wav
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.models.lora import LoraModel, lora_summary
    from avsl_tpu_torch.train.checkpoints import (
        _path,
        latest_step,
        restore_params_only,
        save_checkpoint,
    )
    from avsl_tpu_torch.train.loop import TrainState, batch_to_device
    from avsl_tpu_torch.train.optim import MultiSteps

    vocab_dir = os.path.join(out_dir, "lora_vocab")
    write_published_size_vocab(vocab_dir)
    cfg_path = lora_job_config(out_dir, vocab_dir)
    cfg = FlamingoTrainConfig.from_yaml(cfg_path)
    accum = int(cfg.gradient_accumulation_steps)
    rows = [dataset_rows(n, seed) for n, seed in zip(DATASET_ROWS, (20, 21, 22))]
    job = finetune.make_job(cfg, *rows, "cuda")
    job.train_ds, job.val_ds, job.test_ds = (SeededLipFrames(ds, seed) for ds, seed in zip(
        (job.train_ds, job.val_ds, job.test_ds), (30, 31, 32)))
    set_gates(job.model, GATE)
    runner, base = job.runner, job.model
    lora, opt = runner.state.model, runner.state.optimizer
    if not isinstance(lora, LoraModel) or not isinstance(opt, MultiSteps) or runner.hoisted \
            or not base.encoder.remat or runner.ema is None:
        raise AssertionError(f"LoRA path composed {type(lora).__name__}, {type(opt).__name__}, "
                             f"hoisted {runner.hoisted}, remat {base.encoder.remat}")
    summary = lora_summary(base, lora.adapters())
    by_part = collections.Counter(p.split("/")[0] if "x_attn" not in p else "x_attn"
                                  for p in lora.lora_a)
    log({"phase": "build_flamingo_lora_train", "params": summary["base_params"],
         "n_vocab": base.cfg.n_vocab, "adapters": summary["n_adapters"],
         "adapters_by_part": dict(by_part), "trainable_params": summary["lora_params"],
         "trainable_fraction": summary["trainable_fraction"], "rank": LORA_RANK,
         "alpha": LORA_ALPHA, "ema_decay": LORA_EMA, "remat_policy": base.encoder.remat_policy,
         "accumulation": accum, "optimizer_steps": LORA_STEPS})
    base_before = {n: p.detach().to("cpu", copy=True) for n, p in base.named_parameters()}
    records, eval_calls = [], []
    plain_step = observe_steps(runner, records)
    plain_eval = runner.eval_logits_fn

    def counted_eval(state, batch):
        eval_calls.append(int(np.asarray(batch["labels"]).shape[0]))
        return plain_eval(state, batch)

    runner.eval_logits_fn = counted_eval
    seen: list = []
    with recorded(True, seen):
        fused_attention.launches = fused_attention_bwd.launches = 0
        result = finetune.run(job)
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    runner.train_step, runner.eval_logits_fn = plain_step, plain_eval
    steps = optimizer_steps(records)
    base_changed = [n for n, v in base_before.items()
                    if not torch.equal(dict(base.named_parameters())[n].cpu(), v)]
    del base_before
    zero_b = [p for p, t in lora.lora_b.items() if not bool(t.detach().ne(0).any())]
    best_dir = runner._best_dir
    best = restore_params_only(best_dir, runner.best_step)
    raw = {n: t.detach().cpu() for n, t in lora.named_parameters()}
    best_is_ema = all(torch.equal(best[n], runner.ema[n].cpu()) for n in raw)
    best_is_raw = [n for n in raw if n.startswith("lora_b.") and torch.equal(best[n], raw[n])]
    ckpt_dir = runner.ckpt_dir
    adapter_bytes = os.path.getsize(_path(ckpt_dir, latest_step(ckpt_dir)))
    enc, dec = base.cfg.n_audio_layer, 3 * base.cfg.n_text_layer
    tower = base.video_model.cfg.num_hidden_layers
    micro = len(records)
    want_k1 = (2 * enc + dec) * micro + (enc + tower + dec) * len(eval_calls)
    want_k2 = (enc + dec) * micro
    rec = {"phase": "flamingo_lora_train", "card": card, "optimizer_steps": steps,
           "micro_batch_items": dict(sorted(collections.Counter(
               r["items"] for r in records).items())),
           "max_memory_allocated_bytes": max(r["peak_bytes"] for r in records),
           "micro_steps": micro, "eval_batches": eval_calls,
           "k1_launches": k1, "k2_launches": k2, "expected_k1": want_k1, "expected_k2": want_k2,
           "k1_per_micro_step": 2 * enc + dec, "k2_per_micro_step": enc + dec,
           "k1_per_eval_batch": enc + tower + dec, "updates": opt.count,
           "final_step": result["final_step"], "best_step": runner.best_step,
           "test": result.get("test"), "base_tensors_changed": len(base_changed),
           "adapters_with_zero_b": len(zero_b), "best_holds_ema": best_is_ema,
           "best_equal_to_raw_b": len(best_is_raw),
           "trainable_fraction": summary["trainable_fraction"],
           "adapter_checkpoint_bytes": adapter_bytes,
           "trained_moved_before_update": [i for i, r in enumerate(records)
                                           if not r["updated"] and not r["unchanged"]]}
    if (k1, k2) != (want_k1, want_k2):
        log(rec)
        raise AssertionError(f"LoRA path: launches K1 {k1} / K2 {k2} != {want_k1} / {want_k2}")
    if base_changed or zero_b or not best_is_ema or best_is_raw or rec[
            "trained_moved_before_update"]:
        log(rec)
        raise AssertionError(f"LoRA path: {len(base_changed)} base tensors changed, {zero_b[:3]} "
                             f"B still zero, best holds EMA {best_is_ema}, raw B {best_is_raw[:3]}")
    if opt.count != LORA_STEPS or result["final_step"] != LORA_STEPS * accum \
            or not all(math.isfinite(s["loss"]) for s in steps):
        log(rec)
        raise AssertionError(f"LoRA path: {opt.count} updates, final step {result['final_step']}")

    # the merged export (onto the base as trained on, its gates at 0.5, saved
    # as the base checkpoint), its logits against the LoRA model's, and a
    # served batch
    base_dir, merged_dir = os.path.join(out_dir, "lora_base"), os.path.join(out_dir, "lora_merged")
    save_checkpoint(base_dir, TrainState.create(base, None), 0)
    export_lora.main(["--config", cfg_path, "--adapter_ckpt", ckpt_dir, "--base_ckpt", base_dir,
                      "--output", merged_dir, "--device", "cuda"])
    shutil.rmtree(base_dir, ignore_errors=True)
    rec["merged_checkpoint_bytes"] = os.path.getsize(_path(merged_dir, latest_step(merged_dir)))
    gc.collect()
    torch.cuda.empty_cache()
    tokenizer = get_tokenizer(vocab_dir, cfg.lang)
    served, _, _ = build_target_with_weights(cfg, tokenizer, False, merged_dir, device="cuda")
    batch = batch_to_device(next(iter(job.batches(job.val_ds, 1, False))), torch.device("cuda"))
    with torch.no_grad():
        lora.eval()
        want = lora(batch["input_ids"], batch["dec_input_ids"], video=batch.get("video")).float()
        got = served(batch["input_ids"], batch["dec_input_ids"], video=batch.get("video")).float()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **BF16_TOL))
    del served, got, want
    gc.collect()
    torch.cuda.empty_cache()
    wav_dir = os.path.join(out_dir, "lora_wavs")
    rng = np.random.default_rng(23)
    for i in range(EXTRAS_BATCH):
        write_wav(os.path.join(wav_dir, f"lora{i}.wav"),
                  (0.1 * rng.standard_normal(int(rng.integers(80000, 160001)))).astype(np.float32))
    results = transcribe.main(["--input", wav_dir, "--config", cfg_path, "--ckpt_dir", merged_dir,
                               "--batch_size", str(EXTRAS_BATCH), "--max_new_tokens", "16",
                               "--device", "cuda"])
    rec.update(merged_logits_max_abs_err=err, merged_logits_within_bf16_tol=ok,
               served_items=len(results), shapes_checked=check_launch_shapes(seen))
    shutil.rmtree(merged_dir, ignore_errors=True)
    log(rec)
    if not ok:
        raise AssertionError(f"merged model's logits off the LoRA model's by {err}")
    if len(results) != EXTRAS_BATCH or not all(math.isfinite(r["avg_logprob"]) for r in results):
        raise AssertionError(f"transcribe --ckpt_dir on the merged checkpoint: {results[:2]}")
    return job, {"k1": k1, "k2": k2}


def set_remat(model, on: bool, policy: str) -> None:
    """Every remat site of ``model`` on or off, with ``policy``."""
    for m in model.modules():
        if hasattr(m, "remat_policy") and hasattr(m, "remat"):
            m.remat, m.remat_policy = on, policy


def phase_remat_ab(card: str, job) -> dict:
    """The LoRA job of :func:`phase_flamingo_lora_train` for REMAT_AB_STEPS
    optimizer steps of REMAT_AB_ACCUM micro-batches each (the same
    micro-batches every time),
    with remat off, on with the ``block`` policy and on with ``dots``, in
    that order: peak device memory each, K1 and K2 launches gated to (32 +
    96) or (32 x 2 + 96) and (32 + 96) a micro-step. Returns the launches
    without remat."""
    import itertools

    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train.optim import MultiSteps

    runner, base = job.runner, job.model
    opt = runner.state.optimizer
    micro_batches = list(itertools.islice(job.batches(
        job.train_ds, int(job.cfg.batch_size), True, 5), REMAT_AB_STEPS * REMAT_AB_ACCUM))
    enc, dec = base.cfg.n_audio_layer, 3 * base.cfg.n_text_layer
    runs, launches = {}, {}
    for name, on, policy in (("no_remat", False, "block"), ("block", True, "block"),
                             ("dots", True, "dots")):
        set_remat(base, on, policy)
        runner.state.optimizer = MultiSteps(opt.inner, REMAT_AB_ACCUM)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        fused_attention.launches = fused_attention_bwd.launches = 0
        for b in micro_batches:
            runner.state, metrics = runner.train_step(runner.state, b)
            float(metrics["loss"])
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        micro = len(micro_batches)
        want = ((2 * enc if on else enc) + dec) * micro, (enc + dec) * micro
        runs[name] = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "k1": k1, "k2": k2, "expected": list(want)}
        launches[name] = (k1, k2)
        if (k1, k2) != want:
            raise AssertionError(f"remat_ab {name}: K1 {k1} / K2 {k2} != {want}")
    runner.state.optimizer = opt
    set_remat(base, True, "block")
    log({"phase": "remat_ab", "card": card, "accumulation": REMAT_AB_ACCUM,
         "optimizer_steps": REMAT_AB_STEPS,
         "micro_batch_items": [int(b["labels"].shape[0]) for b in micro_batches], "runs": runs})
    return {"k1": launches["no_remat"][0], "k2": launches["no_remat"][1]}


def phase_distill(card: str, out_dir: str):
    """Draft distillation through ``cli.distill``'s ``main``: the target
    is audio-only large-v2 (bf16, seeded random weights, the published
    vocabulary's size) from a checkpoint this phase saves, the draft
    ``tiny`` in bf16 compute, the input 32 seeded 10-30 s wav clips;
    ``--batch_size 8 --max_new_tokens 64`` and DISTILL_STEPS steps at
    DISTILL_LR. K1/K2 counted in the label pass and in the steps (the
    target's encoder and teacher-forced decoder, the draft's forward and
    backward) against the code's counts, and every distinct launch shape
    held against the plain version. Then speculative decoding on that
    target (30 s windows, batch 8, 64 new tokens, spec_k 4) with the
    distilled draft loaded through the serving CLIs' ``--draft_ckpt`` path,
    against plain greedy: greedy's tokens but at near-ties, K1 32 + 4 a
    batch. Returns the launches."""
    import argparse
    import os

    import yaml

    from avsl_tpu_torch.cli import distill as distill_cli
    from avsl_tpu_torch.cli._serving_common import build_draft, build_target_model
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.audio_segments import write_wav
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train import distill
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.loop import TrainState

    vocab_dir = os.path.join(out_dir, "distill_vocab")
    write_published_size_vocab(vocab_dir)
    fields = dict(model_name="large-v2", add_gated_x_attn=0, use_av_hubert_encoder=False,
                  audio_max_length=480000, download_root=vocab_dir)
    cfg_path = os.path.join(out_dir, "distill.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(fields, f)
    cfg = FlamingoTrainConfig(**fields)
    tokenizer = get_tokenizer(vocab_dir, cfg.lang)
    target, w_cfg = build_target_model(cfg, tokenizer, False, None, device="cuda", seed=7)
    target_dir, draft_dir = os.path.join(out_dir, "distill_target"), os.path.join(
        out_dir, "distill_draft")
    save_checkpoint(target_dir, TrainState.create(target, None), 1)
    wav_dir = os.path.join(out_dir, "distill_wavs")
    rng = np.random.default_rng(24)
    for i in range(DISTILL_CLIPS):
        write_wav(os.path.join(wav_dir, f"clip{i:02d}.wav"),
                  (0.1 * rng.standard_normal(int(rng.integers(160000, 480001)))).astype(np.float32))

    counts = {"labels": [0, 0, 0], "steps": [0, 0, 0]}  # calls, K1, K2
    real_label, real_step = distill.make_greedy_label_fn, distill.make_online_distill_step

    def counting(kind, fn):
        def run(*a, **kw):
            k1, k2 = fused_attention.launches, fused_attention_bwd.launches
            out = fn(*a, **kw)
            c = counts[kind]
            c[0] += 1
            c[1] += fused_attention.launches - k1
            c[2] += fused_attention_bwd.launches - k2
            return out
        return run

    distill.make_greedy_label_fn = lambda *a, **kw: counting("labels", real_label(*a, **kw))
    distill.make_online_distill_step = lambda *a, **kw: counting("steps", real_step(*a, **kw))
    seen: list = []
    try:
        with recorded(True, seen):
            fused_attention.launches = fused_attention_bwd.launches = 0
            summary = distill_cli.main([
                "--input", wav_dir, "--config", cfg_path, "--ckpt_dir", target_dir,
                "--draft_model", "tiny", "--output", draft_dir, "--steps", str(DISTILL_STEPS),
                "--batch_size", "8", "--max_new_tokens", "64", "--lr", str(DISTILL_LR),
                "--log_every", "10", "--device", "cuda"])
    finally:
        distill.make_greedy_label_fn, distill.make_online_distill_step = real_label, real_step
    gc.collect()
    torch.cuda.empty_cache()
    args = argparse.Namespace(draft_model="tiny", draft_ckpt=draft_dir, spec_k=SPEC_K, beam=1,
                              device="cuda")
    draft, draft_weights = build_draft(args, w_cfg.n_vocab, smoke=False)
    d_enc = draft.cfg.n_audio_layer
    d_dec = 2 * draft.cfg.n_text_layer
    t_enc, t_dec = w_cfg.n_audio_layer, 2 * w_cfg.n_text_layer
    n_label_batches = math.ceil(DISTILL_CLIPS / 8)
    want = {"labels": [n_label_batches, t_enc * n_label_batches, 0],
            "steps": [DISTILL_STEPS, (t_enc + t_dec + d_enc + d_dec) * DISTILL_STEPS,
                      (d_enc + d_dec) * DISTILL_STEPS]}
    rec = {"phase": "distill", "card": card, "target": w_cfg.name, "n_vocab": w_cfg.n_vocab,
           "draft": [draft.cfg.n_audio_state, draft.cfg.n_audio_head, draft.cfg.n_audio_layer],
           "clips": DISTILL_CLIPS, "steps": DISTILL_STEPS, "lr": DISTILL_LR,
           "agree_history": [(h["step"], h["agree"]) for h in summary["history"]],
           "loss_history": [(h["step"], h["loss"]) for h in summary["history"]],
           "final": summary["final"], "launches": counts, "expected_launches": want,
           "shapes_checked": check_launch_shapes(seen)}
    if counts != want:
        log(rec)
        raise AssertionError(f"distill launches {counts} != {want}")
    if not all(math.isfinite(v) for v in summary["final"].values()):
        log(rec)
        raise AssertionError(f"distill: non-finite metrics {summary['final']}")
    log(rec)

    # speculative decoding with the distilled draft on the distillation target
    rng = np.random.default_rng(25)
    items = [{"id": f"ds{i}", "audio": (0.1 * rng.standard_normal(int(rng.integers(
        320000, 480001)))).astype(np.float32)} for i in range(EXTRAS_BATCH)]
    kw = dict(audio_max_length=480000, batch_size=EXTRAS_BATCH, max_new_tokens=EXTRAS_MAX_NEW)
    trs = {"plain": StreamingTranscriber(target, tokenizer, **kw),
           "distilled_draft": StreamingTranscriber(target, tokenizer, draft_model=draft,
                                                   draft_variables=draft_weights, spec_k=SPEC_K,
                                                   **kw)}
    k1 = {"plain": t_enc, "distilled_draft": t_enc + d_enc}
    prep = trs["plain"]._prepare_batch(items)
    ref_tokens, ref_gaps = greedy_with_gaps(trs["plain"], prep)
    seen = []
    with recorded(True, seen):
        runs = run_each({name: (lambda tr=tr: tr._run(prep.audio, prep.video))
                         for name, tr in trs.items()}, k1)
    tr, r = trs["distilled_draft"], runs["distilled_draft"]
    stats = tr.spec_stats()
    with spec_probe(SPEC_K) as probe:
        probed = tr._run(prep.audio, prep.video)
    tokens = r["result"].tokens
    if not (probed.tokens == tokens).all():
        raise AssertionError("distilled draft: the probed run's tokens differ from the counted "
                             "run's")
    spec = {"phase": "serving_extras_speculative_distilled", "card": card, "spec_k": SPEC_K,
            "near_tie": NEAR_TIE, "k1_per_batch": r["k1"], "rounds": stats["mean_verify_rounds"],
            "accept_rate": stats["mean_accept_rate"], "spec_stats": stats,
            "draft_forwards": probe["draft_forwards"], "target_forwards": probe["target_forwards"],
            "rejections": len(probe["rejection_gaps"]),
            "near_tie_rows": near_tie_rows(tokens, ref_tokens, ref_gaps),
            "shapes_checked": check_launch_shapes(seen)}
    log(spec)
    launches = {"labels": counts["labels"][1], "steps": counts["steps"][1],
                "steps_k2": counts["steps"][2], "speculative": r["k1"]}
    del trs, tr, draft, target
    return launches


# evaluation and the reference's dataset layer: a synthetic AMI corpus of
# 2 meetings x 4 speakers x 3 segments of 2-10 s, one speaker's headset at
# 48 kHz; the full-width evaluation at the flagship YAML's eval batch of 8
CHAIN_MEETINGS, CHAIN_SPEAKERS, CHAIN_SEGMENTS = ("EN2001a", "EN2003a"), "ABCD", 3
CHAIN_48K = ("EN2003a", "C")
CHAIN_AUDIO_TOL = 1e-4  # libav's decode of a 16-bit slice against load_wav's
EVAL_BATCH, EVAL_BEAM, EVAL_NEW = 8, 4, 64
CHAIN_WORDS = ("okay", "so", "the", "remote", "control", "should", "have", "a", "button",
               "for", "volume", "and", "we", "need", "to", "think", "about", "price", "yeah",
               "design", "battery", "interface", "user", "meeting")


def write_nite_corpus(root: str, seed: int = 0):
    """A seeded NITE-XML corpus (``words/{m}.{s}.words.xml`` and
    ``segments/{m}.{s}.segments.xml`` for every meeting and speaker, words
    of 0.25-0.5 s, segments of 2-10 s apart by 0.5-2 s) and a headset wav
    a speaker of seeded speech-band noise (300-3400 Hz) at 16 kHz, the
    ``CHAIN_48K`` speaker's at 48 kHz. Returns ``{(meeting, speaker): wav}``."""
    import os

    import scipy.io.wavfile as wavfile
    import scipy.signal as signal

    from avsl_tpu_torch.data.ami_xml import AMI_SPEAKERS

    nite = 'xmlns:nite="http://nite.sourceforge.net/"'
    rng = np.random.default_rng(seed)
    for sub in ("words", "segments", "media"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    sources = {}
    for meeting in CHAIN_MEETINGS:
        for speaker in CHAIN_SPEAKERS:
            words, segs, t, n = [], [], 0.5, 0
            for _ in range(CHAIN_SEGMENTS):
                start, end = t, t + float(rng.uniform(2.0, 10.0))
                first = n
                w = start
                while w + 0.25 < end:
                    dur = min(float(rng.uniform(0.25, 0.5)), end - w)
                    text = CHAIN_WORDS[int(rng.integers(len(CHAIN_WORDS)))]
                    words.append(f'<w nite:id="{meeting}.{speaker}.words{n}" '
                                 f'starttime="{w:.2f}" endtime="{w + dur:.2f}">{text}</w>')
                    n, w = n + 1, w + dur + 0.05
                segs.append(f'<segment transcriber_start="{start:.2f}" '
                            f'transcriber_end="{end:.2f}"><nite:child href="{meeting}.{speaker}'
                            f'.words.xml#id({meeting}.{speaker}.words{first})..id({meeting}.'
                            f'{speaker}.words{n - 1})"/></segment>')
                t = end + float(rng.uniform(0.5, 2.0))
            for sub, body in (("words", words), ("segments", segs)):
                with open(os.path.join(root, sub, f"{meeting}.{speaker}.{sub}.xml"), "w") as f:
                    f.write(f'<?xml version="1.0"?>\n<nite:root {nite}>\n' + "\n".join(body)
                            + "\n</nite:root>\n")
            sr = 48000 if (meeting, speaker) == CHAIN_48K else 16000
            sos = signal.butter(4, [300, 3400], btype="band", fs=sr, output="sos")
            noise = signal.sosfilt(sos, rng.standard_normal(int((t + 1.0) * sr)))
            pcm = (0.3 * noise / np.abs(noise).max() * 32767).astype(np.int16)
            channel = AMI_SPEAKERS[speaker]["audio"]
            path = os.path.join(root, "media", f"{meeting}.{channel}.wav")
            wavfile.write(path, sr, pcm)
            sources[(meeting, speaker)] = path
    return sources


def phase_preprocess_chain(card: str, root: str) -> list:
    """The reference's dataset chain on the host, through the port's entry
    points: a synthetic NITE corpus (:func:`write_nite_corpus`) ->
    ``process_transcripts`` -> ``segment_sources(video_sources=None,
    package_hf=False)`` (each headset loaded once, resampled when at 48
    kHz, every segment sliced) -> ``av_to_hf_dataset_with_shards`` ->
    ``load_sharded_records``. Gates: 24 segments, 24 audio slices, no
    alignment issue, the records back in order; where ``cpp/avsl_media`` is
    built (libav), its batch decode of the slices equals ``load_wav``
    within CHAIN_AUDIO_TOL. Returns the records (what ``cli.evaluate``
    reads as a test split)."""
    import os

    from avsl_tpu_torch.data import media_native
    from avsl_tpu_torch.data.ami_xml import process_transcripts
    from avsl_tpu_torch.data.audio_segments import load_wav
    from avsl_tpu_torch.data.dataset_process import segment_sources
    from avsl_tpu_torch.data.hf_dataset import av_to_hf_dataset_with_shards, load_sharded_records

    sources = write_nite_corpus(os.path.join(root, "corpus"))
    written = process_transcripts(os.path.join(root, "corpus"), os.path.join(root, "txt"))
    out = segment_sources(os.path.join(root, "txt"), sources, os.path.join(root, "ds"),
                          video_sources=None, package_hf=False)
    records = out["records"]
    manifest = av_to_hf_dataset_with_shards(records, os.path.join(root, "shards"), num_shards=4,
                                            check_videos=False)
    back = load_sharded_records(os.path.join(root, "shards"))
    n = len(CHAIN_MEETINGS) * len(CHAIN_SPEAKERS) * CHAIN_SEGMENTS
    stats = out["stats"]
    rec = {"phase": "preprocess_chain", "card": card, "transcript_files": len(written),
           "stats": stats, "sharded_records": manifest["n_records"],
           "round_trip_in_order": back == records,
           "durations_s": [min(r["duration"] for r in records),
                           max(r["duration"] for r in records)],
           "native_media_available": media_native.native_available()}
    if rec["native_media_available"]:
        paths = [r["audio"] for r in records]
        arena, counts = media_native.decode_audio_batch(paths, 16000, max_samples=10 * 16000 + 16)
        err = 0.0
        for row, count, path in zip(arena, counts, paths):
            want = load_wav(path)
            err = max(err, float(np.abs(row[:count] - want).max()) if count == len(want)
                      else math.inf)
        rec["native_decode_max_abs_err"] = err
        if not err <= CHAIN_AUDIO_TOL:
            raise AssertionError(f"preprocess_chain: native audio decode differs by {err}")
    log(rec)
    if (stats["segments"], stats["audio_ok"], stats["alignment_issues"]) != (n, n, 0) \
            or len(records) != n or not rec["round_trip_in_order"]:
        raise AssertionError(f"preprocess_chain: {rec}")
    return records


def phase_evaluate_main_path(card: str, model, serve_cfg, records) -> dict:
    """``cli.evaluate``'s ``evaluate`` at full width on the AV serving
    model (large-v2 + AV-HuBERT large, bf16, gates 0.5) with the flagship
    YAML at an eval batch of 8, the serving phases' tokenizer, and the
    chain's 24 records, each given seeded lip frames
    (:class:`SeededLipFrames`): teacher-forced (K1 exactly 152 a batch:
    encoder 32, tower 24, decoder 96), then with beam 4 and 64 new tokens
    (that run's teacher-forced pass again, then 56 a batch: the encoder
    and the tower; the cached steps run the einsum path); K2 never; every
    distinct K1 launch shape against the plain version. Returns the K1
    launches by mode."""
    from avsl_tpu_torch.cli import evaluate as cli_evaluate
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer

    cfg = FlamingoTrainConfig.from_yaml(TRAIN_CONFIG)
    cfg.eval_batch_size = EVAL_BATCH
    if (cfg.model_name, cfg.add_gated_x_attn) != (serve_cfg.model_name, serve_cfg.add_gated_x_attn):
        raise AssertionError(f"{TRAIN_CONFIG} names another model than the serving phases'")
    tokenizer = ByteTokenizer()
    wrap = lambda ds: SeededLipFrames(ds, seed=12)  # noqa: E731
    n_batches = len(records) // EVAL_BATCH
    per_tf = model.cfg.n_audio_layer + model.video_model.cfg.num_hidden_layers \
        + 3 * model.cfg.n_text_layer
    per_beam = model.cfg.n_audio_layer + model.video_model.cfg.num_hidden_layers
    seen = []
    torch.cuda.reset_peak_memory_stats()
    with recorded(True, seen):
        tf, tf_k1, tf_stats, tf_k2 = run_counted(
            lambda: cli_evaluate.evaluate(cfg, model, tokenizer, records, wrap_dataset=wrap))
        both, both_k1, both_stats, both_k2 = run_counted(
            lambda: cli_evaluate.evaluate(cfg, model, tokenizer, records, beam=EVAL_BEAM,
                                          max_new_tokens=EVAL_NEW, wrap_dataset=wrap))
    peak = torch.cuda.max_memory_allocated()
    beam_k1 = both_k1 - tf_k1
    shapes = check_launch_shapes(seen)
    rec = {"phase": "evaluate_main_path", "card": card, "config": TRAIN_CONFIG,
           "model": model.cfg.name, "items": len(records), "batches": n_batches,
           "eval_batch_size": EVAL_BATCH, "beam": EVAL_BEAM, "max_new_tokens": EVAL_NEW,
           "teacher_forced": {"metrics": tf, "k1": tf_k1},
           "beam_search": {"metrics": both, "k1": beam_k1},
           "expected_k1": {"teacher_forced": per_tf * n_batches, "beam": per_beam * n_batches},
           "k2": tf_k2 + both_k2, "row_statistics_written": tf_stats + both_stats,
           "max_memory_allocated_bytes": peak, "shapes_checked": shapes}
    log(rec)
    if (tf_k1, beam_k1) != (per_tf * n_batches, per_beam * n_batches) or tf_k2 or both_k2 \
            or tf_stats or both_stats:
        raise AssertionError(f"evaluate_main_path: K1 {tf_k1} / {beam_k1}, K2 {tf_k2 + both_k2}, "
                             f"expected {per_tf * n_batches} / {per_beam * n_batches}, 0")
    for key in ("test/wer_av", "test/cer_av", "test/wer_beam", "test/cer_beam"):
        if key not in both:
            raise AssertionError(f"evaluate_main_path: {key} missing from {both}")
    if not (math.isfinite(tf["test/loss"]) and math.isfinite(both["test/loss"])):
        raise AssertionError(f"evaluate_main_path: test/loss not finite: {tf}, {both}")
    return {"teacher_forced": tf_k1, "beam": beam_k1}


def phase_evaluate_cli_smoke(card: str) -> tuple:
    """``cli.evaluate --smoke --beam 2 --max_new_tokens 6`` on the card, as
    ``python -m avsl_tpu_torch.cli.evaluate`` runs it: the tiny fp32
    Whisper-Flamingo (its AV-HuBERT tower 2 heads of 16, the head dim the
    D = 16 bodies take) on 4 synthetic rows, one batch: K1 exactly
    (encoder, tower, decoder x 3) teacher-forced plus (encoder, tower) for
    the beam batch, no K2. Returns (K1, K2)."""
    from avsl_tpu_torch.cli import evaluate as cli_evaluate
    from avsl_tpu_torch.core.config import AVHuBERTConfig, WhisperConfig

    w, av = WhisperConfig.tiny_test(), AVHuBERTConfig.tiny_test()
    result, k1, stats_writes, k2 = run_counted(lambda: cli_evaluate.main(
        ["--smoke", "--beam", "2", "--max_new_tokens", "6"]))
    want = 2 * (w.n_audio_layer + av.num_hidden_layers) + 3 * w.n_text_layer
    log({"phase": "evaluate_cli_smoke", "card": card, "cli_json": result,
         "k1_launches": k1, "k2_launches": k2, "expected_k1_k2": [want, 0],
         "tower_head_dim": av.hidden_size // av.num_attention_heads})
    if (k1, k2, stats_writes) != (want, 0, 0) or not math.isfinite(result["test/loss"]) \
            or "test/wer_beam" not in result:
        raise AssertionError(f"cli.evaluate --smoke: K1 {k1} / K2 {k2}, expected {want} / 0: "
                             f"{result}")
    return k1, k2


def phase_avhubert_cli_smoke(card: str) -> tuple:
    """``cli.avhubert_ft --smoke`` on the card: the tiny fp32 AV-HuBERT
    seq2seq model (encoder and decoder 2 heads of 16), 6 steps: K1 and K2
    exactly the decoder's self-attention a step (the encoder trains with
    attention dropout, unfused), then K1 in the eval forward's encoder and
    decoder. Returns (K1, K2)."""
    from avsl_tpu_torch.cli import avhubert_ft
    from avsl_tpu_torch.core.config import AVHuBERTConfig

    cfg = AVHuBERTConfig.tiny_test()
    result, k1, stats_writes, k2 = run_counted(lambda: avhubert_ft.main(["--smoke"]))
    steps, dec = result["steps"], cfg.decoder_layers
    want = (steps * dec + cfg.num_hidden_layers + dec, steps * dec)
    log({"phase": "avhubert_cli_smoke", "card": card, "cli_json": result,
         "k1_launches": k1, "k2_launches": k2, "expected_k1_k2": list(want),
         "head_dims": [cfg.hidden_size // cfg.num_attention_heads,
                       cfg.decoder_hidden_size // cfg.decoder_attention_heads]})
    losses = [result[k] for k in ("first_loss", "last_loss", "eval_loss")]
    if (k1, k2) != want or stats_writes != steps * dec or not all(map(math.isfinite, losses)):
        raise AssertionError(f"cli.avhubert_ft --smoke: K1 {k1} / K2 {k2} / row statistics "
                             f"{stats_writes}, expected {want}: {result}")
    return k1, k2


# the AV-HuBERT tools, the landmark CNN and the preflight
AVH_TOOLS_ROWS, AVH_TOOLS_SECONDS = 8, (2.0, 10.0)
LANDMARK_HELD_OUT_SEED = 20260820
# the CLI's batch 64, its data and steps cut from 20,000 + 1,000 and 3,000
LANDMARK_TRAIN_ARGS = ["--n_train", "2048", "--n_val", "256", "--steps", "300"]
LANDMARK_PX_TOL = 1e-4
# the WARNs the preflight may give on a card's host (no libav headers, no OpenCV)
DOCTOR_WARNS_ALLOWED = ("native media decoder", "video IO fallback chain")


def avh_tool_rows(d: str, n: int, seed: int):
    """``n`` AMI-like segments in ``d``: 2-10 s of seeded noise written by
    the port's ``write_wav``, each with a transcript of meeting vocabulary
    of at most a third as many bytes (byte-level tokens) as it has 25 Hz
    frames, room for the blanks between repeated letters. Returns the
    CSV's path (id, audio, text; no video column, so each row takes the
    zero-clip branch) and the rows."""
    import csv
    import os

    from avsl_tpu_torch.data.audio_segments import write_wav

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        dur = float(rng.uniform(*AVH_TOOLS_SECONDS))
        pcm = (0.1 * rng.standard_normal(int(dur * 16000))).astype(np.float32)
        rows.append({"id": f"seg{i}", "audio": write_wav(os.path.join(d, f"seg{i}.wav"), pcm),
                     "text": " " + _word_transcript(rng, int(dur * 25) // 3)})
    table = os.path.join(d, "segs.csv")
    with open(table, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["id", "audio", "text"])
        writer.writeheader()
        writer.writerows(rows)
    return table, rows


def run_tool(main, argv: list, per_row_k1: int, n_rows: int) -> tuple:
    """``main(argv)``, a CLI of the AV-HuBERT tools over ``n_rows`` rows,
    with K1 and K2 counted, its standard output kept and the peak device
    memory read. Returns (result, record); raises unless K1 launched
    ``per_row_k1`` times a row, with no row statistics and no K2."""
    import io

    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(out):
        result, k1, stats_writes, k2 = run_counted(lambda: main(argv))
    rec = {"rows": n_rows, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "k1": k1, "expected_k1": per_row_k1 * n_rows, "k2": k2,
           "stdout_first_line": out.getvalue().splitlines()[0]}
    if (k1, k2, stats_writes) != (per_row_k1 * n_rows, 0, 0):
        raise AssertionError(f"{argv}: K1 {k1} ({stats_writes} with statistics), K2 {k2}; "
                             f"expected {per_row_k1} a row x {n_rows}")
    return result, rec


def phase_avh_tools_main_path(card: str) -> dict:
    """The AV-HuBERT tools at full width (``configs/avhubert_large.yaml``:
    24 layers of 1024, 16 heads of 64, bf16 compute; random weights) on
    a CSV of AVH_TOOLS_ROWS seeded AMI-like rows (:func:`avh_tool_rows`):
    ``cli.extract`` with the default tap and with ``--layer 12``, then
    ``cli.align``, each through its ``main``. No row has a lip clip, so
    each runs the JAX CLIs' zero-clip branch through the full ResNet.
    Every row is padded to a bucket of 32 frames with no key lengths, so
    K1 runs [1, 16, Tb, Tb, 64] with real frames attending to the pad
    frames, as in JAX. Gates: K1 exactly 24, 12 and 24 a row, no K2;
    every distinct K1 launch shape against the plain version within
    BF16_TOL; every feature file [t, 1024] and finite, t the row's frames,
    the two taps different; every row aligned (no error) with the
    transcript's words, each ending after it starts. Returns the K1
    launches by CLI."""
    import os

    from avsl_tpu_torch.cli import align, extract
    from avsl_tpu_torch.core.config import AVHuBERTConfig

    cfg = AVHuBERTConfig.from_yaml(AVHUBERT_CONFIG)
    layers = cfg.num_hidden_layers
    tap = layers // 2  # --layer 12 of the large card's 24
    rec = {"phase": "avh_tools_main_path", "card": card, "config": AVHUBERT_CONFIG,
           "rows": AVH_TOOLS_ROWS}
    seen: list = []
    bad = []
    with tempfile.TemporaryDirectory() as d:
        table, rows = avh_tool_rows(d, AVH_TOOLS_ROWS, seed=40)
        base = ["--csv", table, "--config", AVHUBERT_CONFIG]
        with recorded(True, seen):
            feats, rec["extract"] = run_tool(
                extract.main, base + ["--output", os.path.join(d, "feats")], layers, len(rows))
            tapped, rec["extract_layer12"] = run_tool(
                extract.main, base + ["--output", os.path.join(d, "feats12"), "--layer", str(tap)],
                tap, len(rows))
            aligned, rec["align"] = run_tool(
                align.main, base + ["--output", os.path.join(d, "aligned.json")], layers,
                len(rows))
        frames = [r.get("n_frames") for r in aligned]
        for r, row in zip(aligned, rows):
            words = r.get("words") or []
            if "error" in r or [w["word"] for w in words] != row["text"].split() \
                    or not all(w["end_s"] > w["start_s"] >= 0 for w in words):
                bad.append(("align", r))
        tap_gap = 0.0
        for full, mid, t in zip(feats, tapped, frames):
            x, y = np.load(full["path"]), np.load(mid["path"])
            for name, z in (("extract", x), ("extract_layer12", y)):
                if z.shape != (t, cfg.hidden_size) or z.dtype != np.float32 \
                        or not np.isfinite(z).all():
                    bad.append((name, full["id"], z.shape))
            if x.shape == y.shape:
                tap_gap = max(tap_gap, float(np.abs(x - y).max()))
    rec.update(frames=frames, buckets=sorted({-(-t // 32) * 32 for t in frames if t}),
               tap_max_abs_difference=tap_gap, align_scores=[r.get("score") for r in aligned],
               words=sum(len(r.get("words") or []) for r in aligned),
               shapes_checked=check_launch_shapes(seen))
    log(rec)
    if bad or len(feats) != len(rows) or len(tapped) != len(rows) or not tap_gap > 0:
        raise AssertionError(f"AV-HuBERT tools: {bad[:3]}, {len(feats)}/{len(tapped)} feature "
                             f"files for {len(rows)} rows, taps {tap_gap}")
    return {name: rec[name]["k1"] for name in ("extract", "extract_layer12", "align")}


def phase_avh_tools_card_vs_cpu(card: str) -> int:
    """The tiny card in fp32 (``tiny_test`` with ``dtype: float32``, written
    as a model card YAML: 2 layers of 2 heads of 16, K1's fp32 D = 16 body
    on the card) through ``cli.extract --config`` on two seeded rows (1.5
    and 2.3 s, neither a bucket's multiple) and ``cli.align --config`` on
    the ``--smoke`` input (a 1 s 300 Hz tone, " hello world"), on the card
    and with ``--device cpu``, each from one checkpoint (random weights
    saved on the CPU by ``save_checkpoint``). ``--tiny`` and ``--smoke``
    themselves compute in bf16 (the tiny card's dtype), where a random
    model's best alignment sits at a near-tie: the card and the CPU part
    there. Gates: features within SMALL_TRAIN_TOL, the same words and
    spans, alignment scores within 1e-3, K1 exactly 2 a row on the card
    and none on the CPU, no K2. Returns the card's K1 launches."""
    import csv
    import dataclasses
    import io
    import os

    import yaml

    from avsl_tpu_torch.cli import align, extract
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.data.audio_segments import write_wav
    from avsl_tpu_torch.data.tokenizer import get_tokenizer
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.loop import TrainState

    cfg = AVHuBERTConfig.tiny_test(dtype="float32", vocab_size=get_tokenizer(None, "en").vocab_size)
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        card_yaml = os.path.join(d, "tiny_fp32.yaml")
        with open(card_yaml, "w") as f:
            yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                            for k, v in dataclasses.asdict(cfg).items()}, f)
        for head in ("encoder", "ctc"):
            save_checkpoint(os.path.join(d, head), TrainState.create(
                build_avhubert(cfg, head, device="cpu", seed=3), None), 1)
        rng = np.random.default_rng(41)
        table = os.path.join(d, "tiny.csv")
        with open(table, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["id", "audio"])
            for i, seconds in enumerate((1.5, 2.3)):
                pcm = (0.1 * rng.standard_normal(int(seconds * 16000))).astype(np.float32)
                writer.writerow([f"tiny{i}", write_wav(os.path.join(d, f"tiny{i}.wav"), pcm)])
        tone = write_wav(os.path.join(d, "smoke.wav"), (0.1 * np.sin(
            2 * np.pi * 300 * np.arange(16000) / 16000)).astype(np.float32))
        for dev in ("cuda", "cpu"):
            def both(dev=dev):
                common = ["--config", card_yaml, "--device", dev]
                return (extract.main(["--csv", table, "--ckpt_dir", os.path.join(d, "encoder"),
                                      "--output", os.path.join(d, dev), *common]),
                        align.main(["--audio", tone, "--id", "smoke", "--text", " hello world",
                                    "--ckpt_dir", os.path.join(d, "ctc"), *common]))

            with contextlib.redirect_stdout(io.StringIO()):
                (feats, aligned), k1, stats_writes, k2 = run_counted(both)
            runs[dev] = {"feats": [np.load(r["path"]) for r in feats], "aligned": aligned,
                         "k1": k1, "k2": k2, "stats": stats_writes}
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    errs = [float(np.abs(a - b).max()) for a, b in zip(card_run["feats"], cpu_run["feats"])]
    within = len(errs) == 2 and all(
        a.shape == b.shape and np.allclose(a, b, **SMALL_TRAIN_TOL)
        for a, b in zip(card_run["feats"], cpu_run["feats"]))
    words = [r["aligned"][0].get("words") for r in (card_run, cpu_run)]
    scores = [r["aligned"][0].get("score") for r in (card_run, cpu_run)]
    want_k1 = cfg.num_hidden_layers * (len(card_run["feats"]) + 1)
    log({"phase": "avh_tools_card_vs_cpu", "card": card, "tolerance": SMALL_TRAIN_TOL,
         "feature_shapes": [list(a.shape) for a in card_run["feats"]],
         "features_max_abs_err": errs, "words_card": words[0], "words_equal": words[0] == words[1],
         "align_score": scores, "k1": {dev: r["k1"] for dev, r in runs.items()},
         "expected_card_k1": want_k1})
    counts = [(r["k1"], r["k2"], r["stats"]) for r in (card_run, cpu_run)]
    if not within or not words[0] or words[0] != words[1] or None in scores \
            or abs(scores[0] - scores[1]) > 1e-3 or counts != [(want_k1, 0, 0), (0, 0, 0)]:
        raise AssertionError(f"tiny AV-HuBERT tools card vs CPU: features {errs}, words "
                             f"{words}, scores {scores}, (K1, K2, statistics) {counts}, K1 "
                             f"expected {want_k1}")
    return card_run["k1"]


def phase_landmark_cnn(card: str) -> dict:
    """The landmark CNN (five cuDNN convolutions and two dense layers, no
    kernel of the port's): ``CNNLandmarkDetector`` on the shipped weights
    over JAX's held-out synthetic faces (48 at 128 x 128, seed 20260820,
    no resize), card against CPU within LANDMARK_PX_TOL px (TF32 off) and
    against the exact labels at the JAX truth test's limits (mouth under 8
    px, all points under 11 px, the worst face's mouth under 35 px); then
    ``cli.train_landmarks.main`` on the card at the CLI's batch 64 with
    LANDMARK_TRAIN_ARGS (2,048 + 256 faces, 300 steps) into a temporary
    file, read back by ``load_cnn_params`` with flax's keys. Raises on a
    non-finite loss. Returns the record."""
    import io
    import os

    from avsl_tpu_torch.cli import train_landmarks
    from avsl_tpu_torch.data.landmarks import CNNLandmarkDetector, load_cnn_params
    from avsl_tpu_torch.data.synthetic_faces import generate_dataset

    imgs, lms = generate_dataset(48, seed=LANDMARK_HELD_OUT_SEED)
    imgs = imgs.astype(np.uint8)
    det = CNNLandmarkDetector(device="cuda")
    got = np.stack(det(imgs))
    want = np.stack(CNNLandmarkDetector(device="cpu")(imgs))
    err = float(np.abs(got - want).max())
    errors = np.linalg.norm(got - lms * imgs.shape[-1], axis=-1)
    truth = {"mouth_px": float(errors[:, 48:68].mean()), "all_px": float(errors.mean()),
             "worst_face_mouth_px": float(errors[:, 48:68].mean(axis=1).max())}
    rec = {"phase": "landmark_cnn", "card": card, "faces": len(imgs),
           "card_vs_cpu_max_abs_px": err, "tolerance_px": LANDMARK_PX_TOL, "held_out": truth}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "landmark_cnn.npz")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = train_landmarks.main(LANDMARK_TRAIN_ARGS + ["--out", path])
        with np.load(path) as z:
            keys = sorted(z.files)
        state = load_cnn_params(path)
        trained = np.stack(CNNLandmarkDetector(params=state, device="cuda")(imgs))
    losses = result["losses"]
    steps = int(LANDMARK_TRAIN_ARGS[LANDMARK_TRAIN_ARGS.index("--steps") + 1])
    want_keys = sorted(f"params/{layer}/{leaf}"
                       for layer in [f"Conv_{i}" for i in range(5)] + ["Dense_0", "Dense_1"]
                       for leaf in ("kernel", "bias"))
    rec["train"] = {
        "args": LANDMARK_TRAIN_ARGS, "batch_size": 64,
        "loss_history": [[i, losses[i]] for i in range(0, len(losses), 25)]
        + [[len(losses) - 1, losses[-1]]],
        "val_px_error": result["val_px_error"], "val_mouth_px_error": result["val_mouth_px_error"],
        "held_out_mouth_px_after": float(np.linalg.norm(
            trained - lms * imgs.shape[-1], axis=-1)[:, 48:68].mean()),
        "flax_keys": keys == want_keys, "stdout_first_line": out.getvalue().splitlines()[0]}
    log(rec)
    if err > LANDMARK_PX_TOL or not (truth["mouth_px"] < 8.0 and truth["all_px"] < 11.0
                                     and truth["worst_face_mouth_px"] < 35.0):
        raise AssertionError(f"landmark CNN: card vs CPU {err:.3e} px, held out {truth}")
    if len(losses) != steps or not np.isfinite(losses).all() or keys != want_keys \
            or set(state) != set(det.net.state_dict()):
        raise AssertionError(f"train_landmarks: {len(losses)} losses (finite "
                             f"{bool(np.isfinite(losses).all())}), keys {keys}")
    return rec


def phase_doctor(card: str) -> int:
    """``cli.doctor.main([])`` and ``main(["--config",
    configs/avhubert_large.yaml])`` on the card: exit code 0, no FAIL, WARNs
    only in DOCTOR_WARNS_ALLOWED (each logged), and exactly one K1 launch
    each (the kernel probe). Returns the K1 launches."""
    import io

    from avsl_tpu_torch.cli import doctor

    runs, total = {}, 0
    for argv in ([], ["--config", AVHUBERT_CONFIG]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, k1, stats_writes, k2 = run_counted(lambda: doctor.main(argv))
        checks = [line for line in out.getvalue().splitlines() if line.startswith("[")]
        warns = [line for line in checks if line.startswith("[WARN]")]
        fails = [line for line in checks if line.startswith("[FAIL]")]
        runs[" ".join(argv) or "(no arguments)"] = {"rc": rc, "k1": k1, "checks": checks,
                                                     "warns": warns}
        unexpected = [w for w in warns if not w[len("[WARN] "):].startswith(DOCTOR_WARNS_ALLOWED)]
        if rc != 0 or fails or unexpected or (k1, k2, stats_writes) != (1, 0, 0):
            log({"phase": "doctor", "card": card, "runs": runs})
            raise AssertionError(f"doctor {argv}: rc {rc}, FAIL {fails}, WARN {unexpected}, "
                                 f"K1 {k1}, K2 {k2}")
        total += k1
    log({"phase": "doctor", "card": card, "runs": runs})
    return total


def sass_counts() -> dict:
    """Tensor-core instructions in each built library, from the toolkit's
    ``cuobjdump -sass``: ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)."""
    from pathlib import Path

    from avsl_tpu_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    counts = {}
    for name in SOURCES:
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(name)[1])],
                              capture_output=True, text=True, check=True).stdout
        ops = re.findall(r"\b(HGMMA|HMMA)\.", sass)
        counts[name] = {op: ops.count(op) for op in ("HGMMA", "HMMA")}
    if not counts["flash_attn_fwd"]["HGMMA"]:
        raise AssertionError(f"flash_attn_fwd has no HGMMA instruction: {counts}")
    if not sum(counts["flash_attn_bwd"].values()):
        raise AssertionError(f"flash_attn_bwd has no HGMMA or HMMA instruction: {counts}")
    return counts


# the mesh phases: the flagship model at world size 1 over NCCL, four
# ways from one state, MESH_STEPS optimizer steps of MESH_ACCUM
# micro-batches each (the Flamingo phase's seeded batches)
MESH_ACCUM, MESH_STEPS = 2, 2
MESH_VARIANTS = ("no_mesh", "replicated_sp", "zero1", "fsdp")
# every mesh variant against the no-mesh runner: at world size 1 each runs
# the no-mesh arithmetic (FSDP at a data axis of 1 is JAX's no-op, sequence
# parallelism at a model axis of 1 splits nothing), so each is held
# bit-equal: losses, grad norms, trained tensors and BatchNorm statistics
# FSDP's per-rank bytes of parameters and Adam moments against the split
# state_shardings(fsdp=True) implies (FSDP2 splits small leaves too)
MESH_BYTES_MARGIN = 0.10
# the host-CPU ranks: the tiny Whisper-Flamingo (Whisper dropout 0.1, the
# tiny tower's own rates) over 2 gloo ranks against one process
MESH_CPU_VARIANTS = {"dp2": dict(mp=1), "dp2_zero1": dict(mp=1, zero1=True),
                     "dp2_fsdp": dict(mp=1, fsdp=True), "dp1_mp2_sp": dict(mp=2, sp=True)}
# the tiny transcriber (gates 0.5) over 2 gloo ranks: tokens equal to one
# process's, log-probabilities within the transcriber's 4-place rounding
MESH_CPU_SERVE = {"mp2": 2, "dp2": 1}
MESH_CPU_SERVE_KW = dict(audio_max_length=16000, video_frames=25, batch_size=4,
                         max_new_tokens=6)
MESH_CPU_LOGPROB_TOL = 1e-4
MESH_CPU_TOL = dict(rtol=1e-6, atol=1e-6)
# the tiny CTC AV-HuBERT with 4 experts of top 2 at capacity factor 0.5
# (half the claims find no slot, so the global routing differs from a
# rank-local one) over the 2 gloo ranks: data 2 x expert 1, data 1 x
# expert 2
MESH_CPU_MOE = {"dp2_ep1": 1, "dp1_ep2": 2}
MESH_CPU_MOE_CF, MESH_CPU_MOE_LR = 0.5, 1e-3
# the tiny Whisper encoder with a pooled head pipelined over the 2 gloo
# ranks as 2 stages (data 1), forward and 2 train steps
MESH_CPU_STAGES = 2
# an attention key bias's gradient is zero in exact arithmetic (the
# softmax cancels q . b_k), so Adam turns its rounding noise into a step
# of the learning rate: those tensors are held within 3 learning rates
MESH_CPU_KEY_BIAS_ATOL = 3 * MESH_CPU_MOE_LR


def phase_mesh_train_main_path(card: str, cfg, tokenizer, batches, out_dir: str) -> dict:
    """Whisper-Flamingo fine-tuning on a (data, model) mesh through the
    port's ``cli.finetune.make_runner`` at full width (large-v2 +
    AV-HuBERT large, the training YAML, accumulation MESH_ACCUM, warmup 1)
    in a process group of one rank over NCCL: the runner built four ways
    from one seeded state (no mesh; ``make_mesh(1)`` replicated, its step
    rebuilt with ``sequence_parallel=True`` by :func:`sp_train_step`;
    ZeRO-1; FSDP), each MESH_STEPS
    optimizer steps on the same batches. Gates: each mesh variant's
    losses, grad norms, trained tensors and BatchNorm statistics bit-equal
    to the no-mesh runner's, its K1 and K2 counts equal; the FSDP checkpoint
    restores through ``restore_sharded`` into a replicated runner and back
    into the FSDP runner, bit-equal; FSDP's per-rank state bytes within
    MESH_BYTES_MARGIN of ``state_shardings(fsdp=True)``. Logs peak memory
    per variant."""
    import copy
    import os
    import shutil

    import torch.distributed as dist

    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.core.mesh import DATA_AXIS, make_mesh
    from avsl_tpu_torch.core.partitioning import local_tensor, state_shardings
    from avsl_tpu_torch.kernels.attention import fused_attention, fused_attention_bwd
    from avsl_tpu_torch.train.checkpoints import restore_sharded, save_checkpoint
    from avsl_tpu_torch.utils.memory import get_memory_stats

    cfg = copy.copy(cfg)
    cfg.gradient_accumulation_steps, cfg.warmup_steps = MESH_ACCUM, 1
    steps = [{k: v[:MESH_ACCUM] for k, v in b.items()} for b in batches[:MESH_STEPS]]
    root = os.path.join(out_dir, "mesh")
    os.makedirs(root, exist_ok=True)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "rendezvous"),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)

        def build(variant):
            v_cfg = copy.copy(cfg)
            v_cfg.zero1, v_cfg.fsdp = variant == "zero1", variant == "fsdp"
            model, _ = finetune.build_model(v_cfg, tokenizer, "cuda", vocab_size=LARGE_V2_VOCAB)
            set_gates(model, GATE)
            runner = finetune.make_runner(v_cfg, model, tokenizer,
                                          log_dir=os.path.join(root, variant),
                                          ckpt_dir=os.path.join(root, variant, "ckpt"),
                                          mesh=None if variant == "no_mesh" else mesh)
            if variant == "replicated_sp":
                runner.train_step = sp_train_step(runner, model, v_cfg, mesh)
            return model, runner

        def whole(runner, name, p):
            layout = runner.state.layout
            return p.detach() if layout is None else layout.full(name, p)

        def state_bytes(runner):
            opt = runner.state.optimizer
            held = [local_tensor(p) for p in runner.state.model.parameters()] + opt.mu + opt.nu
            return sum(t.numel() * t.element_size() for t in held)

        ref, variants = None, {}
        for variant in MESH_VARIANTS:
            free_cuda()
            model, runner = build(variant)
            reshaped = [runner.reshape_accum(b) for b in steps]
            torch.cuda.reset_peak_memory_stats()
            fused_attention.launches = fused_attention_bwd.launches = 0
            records, _ = train_steps(runner, reshaped, lambda: None)
            k1, k2 = fused_attention.launches, fused_attention_bwd.launches
            named = dict(model.named_parameters())
            opt = runner.state.optimizer
            # compared on the card: the no-mesh run's trained tensors (2.5 GB)
            # stay there
            trained = {n: whole(runner, n, named[n]).clone() for n in opt.names}
            stats = {n: b.detach().clone() for n, b in model.named_buffers() if "running_" in n}
            rec = {"loss": [r["loss"] for r in records],
                   "grad_norm": [r["grad_norm"] for r in records],
                   "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "memory_stats_gb": get_memory_stats(), "state_bytes": state_bytes(runner),
                   "k1": k1, "k2": k2, "layout": None if runner.state.layout is None else {
                       "tp": len(runner.state.layout.tp), "zero": len(runner.state.layout.zero),
                       "fsdp": runner.state.layout.fsdp}}
            if ref is None:
                ref = dict(rec, trained=trained, stats=stats)
            else:
                diff = max(float((trained[n] - ref["trained"][n]).abs().max()) for n in trained)
                del trained
                sdiff = max(float((stats[n] - ref["stats"][n]).abs().max()) for n in stats)
                rec.update(trained_max_abs_diff=diff, stats_max_abs_diff=sdiff,
                           bit_equal=diff == 0.0 and sdiff == 0.0
                           and rec["loss"] == ref["loss"] and rec["grad_norm"] == ref["grad_norm"])
                if not rec["bit_equal"]:
                    raise AssertionError(f"mesh {variant}: loss {rec['loss']} / {ref['loss']}, "
                                         f"grad norm {rec['grad_norm']} / {ref['grad_norm']}, "
                                         f"trained tensors off by {diff}, statistics by {sdiff}")
                if (k1, k2) != (ref["k1"], ref["k2"]):
                    raise AssertionError(f"mesh {variant}: K1/K2 {k1}/{k2} != no mesh "
                                         f"{ref['k1']}/{ref['k2']}")
            if variant == "no_mesh":
                want_k1 = (model.cfg.n_audio_layer + 3 * model.cfg.n_text_layer) * MESH_ACCUM \
                    * MESH_STEPS
                if (k1, k2) != (want_k1, 3 * model.cfg.n_text_layer * MESH_ACCUM * MESH_STEPS):
                    raise AssertionError(f"mesh no_mesh: K1/K2 {k1}/{k2}")
                if not all(bool((trained[n] != 0).any()) for n in list(trained)[:4]):
                    raise AssertionError("mesh no_mesh: trained tensors are zero")
            variants[variant] = rec
            if variant != "fsdp":
                del model, runner, named, opt, stats
            trained = None
        del ref
        fsdp_runner, fsdp_model = runner, model

        # the FSDP per-rank state against JAX's fsdp layout
        specs = state_shardings(fsdp_runner.state, mesh, fsdp=True)
        dp = mesh.shape[DATA_AXIS]
        shapes = fsdp_runner.state.layout.shapes

        def implied(name, spec, copies):
            n = math.prod(shapes[name]) * 4
            return copies * (n // dp if DATA_AXIS in spec else n)

        implied_bytes = sum(implied(n, s, 1) for n, s in specs["params"].items()) + \
            sum(implied(n, s, 2) for n, s in specs["opt_state"].items())
        share = variants["fsdp"]["state_bytes"] / implied_bytes
        if abs(share - 1.0) > MESH_BYTES_MARGIN:
            raise AssertionError(f"mesh fsdp: {variants['fsdp']['state_bytes']} state bytes a "
                                 f"rank against {implied_bytes} implied")

        # the FSDP checkpoint into a replicated runner and back
        ckpt = os.path.join(root, "fsdp_ckpt")
        save_checkpoint(ckpt, fsdp_runner.state, MESH_STEPS)
        ckpt_bytes = os.path.getsize(os.path.join(ckpt, f"step_{MESH_STEPS}.pt"))
        rep_model, rep_runner = build("replicated")
        restore_sharded(ckpt, rep_runner.state, mesh)
        fsdp_named, rep_named = dict(fsdp_model.named_parameters()), dict(rep_model.named_parameters())
        fsdp_layout = fsdp_runner.state.layout

        def mismatches():
            bad = [n for n, p in rep_named.items()
                   if not torch.equal(p.detach(), fsdp_layout.full(n, fsdp_named[n]))]
            f_opt, r_opt = fsdp_runner.state.optimizer, rep_runner.state.optimizer
            bad += [f"mu:{n}" for n, a, b in zip(f_opt.names, f_opt.mu, r_opt.mu)
                    if not torch.equal(fsdp_layout.full(n, a, moment=True), b)]
            bad += [f"nu:{n}" for n, a, b in zip(f_opt.names, f_opt.nu, r_opt.nu)
                    if not torch.equal(fsdp_layout.full(n, a, moment=True), b)]
            if f_opt.count != r_opt.count or fsdp_runner.state.step != rep_runner.state.step:
                bad.append("counts")
            return bad

        into_replicated = mismatches()
        with torch.no_grad():  # then back: wipe the FSDP runner's trained state, restore it
            for n in fsdp_runner.state.optimizer.names:
                local_tensor(fsdp_named[n]).zero_()
            for m in fsdp_runner.state.optimizer.mu + fsdp_runner.state.optimizer.nu:
                m.zero_()
        restore_sharded(ckpt, fsdp_runner.state, mesh, fsdp=True)
        back_into_fsdp = mismatches()
        shutil.rmtree(ckpt, ignore_errors=True)
        log({"phase": "mesh_train_main_path", "card": card, "world_size": dist.get_world_size(),
             "backend": dist.get_backend(), "mesh": mesh.shape, "accumulation": MESH_ACCUM,
             "optimizer_steps": MESH_STEPS, "variants": variants,
             "fsdp_state_bytes_over_implied": share, "fsdp_implied_bytes": implied_bytes,
             "checkpoint_bytes": ckpt_bytes,
             "restore_mismatches": {"into_replicated": into_replicated[:5],
                                    "back_into_fsdp": back_into_fsdp[:5]}})
        if into_replicated or back_into_fsdp:
            raise AssertionError(f"mesh: restore_sharded mismatches {into_replicated[:3]} "
                                 f"{back_into_fsdp[:3]}")
        del fsdp_runner, fsdp_model, rep_model, rep_runner, runner, model
        return {"k1": variants["no_mesh"]["k1"] * len(MESH_VARIANTS),
                "k2": variants["no_mesh"]["k2"] * len(MESH_VARIANTS)}
    finally:
        dist.destroy_process_group()


def sp_train_step(runner, model, cfg, mesh):
    """``runner``'s step as ``cli.finetune.make_runner`` builds it (no
    LoRA, no cross-batch accumulation), with ``sequence_parallel=True``:
    the runner's own step takes JAX's default, which at a model axis of 1
    leaves sequence parallelism off."""
    from avsl_tpu_torch.train.loop import make_train_step
    from avsl_tpu_torch.train.objectives import flamingo_loss_fn, flamingo_tower_precompute
    from avsl_tpu_torch.train.optim import FROZEN, TRAIN

    mixing = dict(spec_augment=getattr(cfg, "spec_augment", None),
                  prob_av=float(cfg.prob_use_av), prob_a=float(cfg.prob_use_a))
    loss_fn = flamingo_loss_fn(
        model, train=True,
        freeze_video_bn_stats=bool(getattr(cfg, "freeze_video_batch_norm_stats", False)),
        **mixing)
    trained = set(runner.state.optimizer.names)
    labels = {n: TRAIN if n in trained else FROZEN for n, _ in model.named_parameters()}
    precompute = flamingo_tower_precompute(model, train=True, freeze_video_bn_stats=True,
                                           **mixing) if runner.hoisted else None
    return make_train_step(loss_fn, mesh=mesh, grad_accum_steps=runner.accum,
                           param_labels=labels, precompute_fn=precompute,
                           zero1=runner.zero1, fsdp=runner.fsdp, sequence_parallel=True)


MESH_SERVE_BEAM = 2


def phase_mesh_serving_main_path(card: str, model, serve_cfg, av_record: dict) -> int:
    """The flagship Whisper-Flamingo transcriber on a (data, model) mesh
    of one rank over NCCL, built through
    ``cli/_serving_common.py::build_transcriber`` (a process group of one:
    ``make_mesh(1, 1)`` and ``shard_state``) on the AV phase's model (the
    builder is handed that model rather than building 2.5 B parameters
    again, and that mesh, which flags of 1 x 1 do not ask for), greedy then beam MESH_SERVE_BEAM over the AV main path's 16
    items at its serving shape. Gates: greedy tokens bit-equal to the AV
    main path's no-mesh run in this call, beam tokens bit-equal to a
    no-mesh beam run here, exactly 56 K1 a batch (32 encoder + 24 tower).
    Logs peak memory per run beside the no-mesh run's. Returns the mesh
    runs' K1 launches."""
    import argparse
    import os

    import torch.distributed as dist

    from avsl_tpu_torch.cli import _serving_common
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.infer.pipeline import StreamingTranscriber

    items = av_items(len(av_record["tokens"]))
    batch, max_new = 8, 64
    n_batches = math.ceil(len(items) / batch)
    per_batch = model.cfg.n_audio_layer + model.video_model.cfg.num_hidden_layers
    out, launches = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
                                rank=0, world_size=1)
        # the AV phase's model, and the 1 x 1 mesh the flags cannot ask for
        builder, mesher = _serving_common.build_target_with_weights, _serving_common.serving_mesh
        _serving_common.build_target_with_weights = lambda *a, **kw: (model, model.cfg, None)
        _serving_common.serving_mesh = lambda args: make_mesh(1, model_parallel=1)
        try:
            for beam in (1, MESH_SERVE_BEAM):
                args = argparse.Namespace(batch_size=batch, max_new_tokens=max_new, beam=beam,
                                          ckpt_dir=None, device="cuda", smoke=False,
                                          model_parallel=1, data_parallel=1)
                tr = _serving_common.build_transcriber(args, serve_cfg)
                if tr.mesh is None or tr.mesh.shape != {"data": 1, "model": 1}:
                    raise AssertionError(f"mesh_serving: the transcriber's mesh is {tr.mesh}")
                if beam == 1:  # the AV main path's no-mesh run in this call
                    want = av_record["tokens"]
                    plain_peak = av_record["max_memory_allocated_bytes"]
                else:  # a no-mesh run here, just before the mesh one
                    plain = StreamingTranscriber(
                        model, tr.tokenizer, audio_max_length=tr.audio_max_length,
                        video_frames=tr.video_frames, batch_size=batch,
                        max_new_tokens=max_new, beam_size=beam)
                    torch.cuda.reset_peak_memory_stats()
                    want = [list(r.tokens) for r in plain.transcribe(items)]
                    plain_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                results, k1, stats_writes, k2 = run_counted(lambda: tr.transcribe(items))
                check_served(results, len(items), max_new)
                got = [list(r.tokens) for r in results]
                if k1 != per_batch * n_batches or k2 or stats_writes:
                    raise AssertionError(f"mesh_serving beam {beam}: K1 {k1} (want "
                                         f"{per_batch * n_batches}), K2 {k2}")
                if got != want:
                    bad = [r.id for r, g, w in zip(results, got, want) if g != w]
                    raise AssertionError(f"mesh_serving beam {beam}: tokens differ from the "
                                         f"no-mesh transcriber's on {bad}")
                launches += k1
                out["greedy" if beam == 1 else f"beam{beam}"] = {
                    "k1_per_batch": k1 / n_batches, "tokens_bit_equal": True,
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "no_mesh_max_memory_allocated_bytes": plain_peak}
        finally:
            _serving_common.build_target_with_weights = builder
            _serving_common.serving_mesh = mesher
            dist.destroy_process_group()
    log({"phase": "mesh_serving_main_path", "card": card, "mesh": {"data": 1, "model": 1},
         "items": len(items), "batches": n_batches, "batch": batch, "max_new_tokens": max_new,
         "runs": out})
    return launches


# expert parallelism at full width: AV-HuBERT large (1024 wide, 16 heads,
# 24 layers, FFN 4096) with the seq2seq head and 8 experts of top 2 in
# every encoder block, through cli.avhubert_ft's step (the CLI's batch of 4
# items of 24 frames) on a 1 x 1 make_ep_mesh and on no mesh, EP_STEPS each
EP_EXPERTS, EP_TOP_K, EP_STEPS = 8, 2, 3


def phase_ep_avhubert_main_path(card: str) -> dict:
    """``cli/avhubert_ft.py::train`` (the CLI's run) on the MoE AV-HuBERT
    large card, EP_EXPERTS experts of top EP_TOP_K, in a process group of
    one rank over NCCL: first with no mesh, then on ``make_ep_mesh(1, 1)``
    passed explicitly (flags of 1 x 1 build no mesh, as in JAX), from the
    same seed. Gates: the losses, every step's ``moe_aux`` and grad norm,
    the eval loss and every trained tensor bit-equal to the no-mesh run
    (at world size 1 the mesh splits nothing and the routing is one
    device's); K1 and K2 launched in every step, the same counts in both
    runs. Logs peak memory, ``moe_aux``, K1/K2 a step and
    ``sharded_params``. Every tensor trains here, the ResNet stem's
    convolutions too, whose cuDNN weight gradients are not deterministic by
    default: the phase runs with ``torch.use_deterministic_algorithms`` (and
    deterministic cuDNN), so that two runs can be compared bit for bit."""
    import os

    import torch.distributed as dist

    import avsl_tpu_torch.train as train_pkg
    from avsl_tpu_torch.cli import avhubert_ft
    from avsl_tpu_torch.kernels import attention
    from avsl_tpu_torch.models.moe import make_ep_mesh

    args = ["--config", AVHUBERT_CONFIG, "--steps", str(EP_STEPS), "--n_experts",
            str(EP_EXPERTS), "--moe_top_k", str(EP_TOP_K), "--device", "cuda"]
    build = train_pkg.make_train_step
    steps: list = []

    def counted_make_train_step(*a, **kw):  # each step's K1/K2 launches
        step = build(*a, **kw)

        def counted(state, batch):
            k1, k2 = attention.fused_attention.launches, attention.fused_attention_bwd.launches
            out = step(state, batch)
            steps.append({"k1": attention.fused_attention.launches - k1,
                          "k2": attention.fused_attention_bwd.launches - k2})
            return out

        return counted

    runs, kept = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
                                rank=0, world_size=1)
        train_pkg.make_train_step = counted_make_train_step
        cudnn_deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name in ("no_mesh", "ep_1x1"):
                mesh = None if name == "no_mesh" else make_ep_mesh(1, experts_parallel=1)
                steps.clear()
                torch.cuda.reset_peak_memory_stats()
                (result, state, history), k1, _, k2 = run_counted(
                    lambda: avhubert_ft.train(avhubert_ft.parse_args(args), mesh))
                named = dict(state.model.named_parameters())
                trained = {n: (p.detach() if state.layout is None
                               else state.layout.full(n, p)) for n, p in named.items()}
                runs[name] = {
                    "result": result, "k1": k1, "k2": k2,
                    "steps": [dict(st, loss=float(m["loss"]), moe_aux=float(m["moe_aux"]),
                                   grad_norm=float(m["grad_norm"]))
                              for st, m in zip(list(steps), history)],
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "params": sum(p.numel() for p in named.values()),
                    "mesh": None if mesh is None else dict(mesh.shape)}
                if kept is None:
                    kept = {n: t.clone() for n, t in trained.items()}
                else:
                    differ = sorted(n for n, t in trained.items() if not torch.equal(t, kept[n]))
                    runs[name]["tensors_differing"] = differ
                del state, named, trained, history
                free_cuda()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn_deterministic
            train_pkg.make_train_step = build
            dist.destroy_process_group()
    del kept
    free_cuda()
    base, ep = runs["no_mesh"], runs["ep_1x1"]
    log({"phase": "ep_avhubert_main_path", "card": card, "experts": EP_EXPERTS,
         "top_k": EP_TOP_K, "steps": EP_STEPS, "runs": runs,
         "sharded_params": ep["result"]["sharded_params"], "mesh": ep["result"]["mesh"],
         "moe_aux": [st["moe_aux"] for st in ep["steps"]],
         "k1_per_step": [st["k1"] for st in ep["steps"]],
         "k2_per_step": [st["k2"] for st in ep["steps"]]})
    same = ([st["loss"] for st in ep["steps"]] == [st["loss"] for st in base["steps"]]
            and [st["moe_aux"] for st in ep["steps"]] == [st["moe_aux"] for st in base["steps"]]
            and [st["grad_norm"] for st in ep["steps"]]
            == [st["grad_norm"] for st in base["steps"]]
            and ep["result"]["eval_loss"] == base["result"]["eval_loss"])
    if not same or ep["tensors_differing"]:
        raise AssertionError(f"ep_avhubert_main_path: the 1 x 1 EP mesh differs from no mesh: "
                             f"{ep['tensors_differing'][:5]}, {ep['steps']} vs {base['steps']}")
    if ep["mesh"] != {"data": 1, "expert": 1} or not all(
            math.isfinite(st["loss"]) and 0.0 < st["moe_aux"] <= EP_EXPERTS
            for st in ep["steps"]):
        raise AssertionError(f"ep_avhubert_main_path: {ep['mesh']}, {ep['steps']}")
    per_step = [(st["k1"], st["k2"]) for st in ep["steps"]]
    if (len(per_step) != EP_STEPS or any(k1 <= 0 or k2 <= 0 for k1, k2 in per_step)
            or per_step != [(st["k1"], st["k2"]) for st in base["steps"]]
            or (ep["k1"], ep["k2"]) != (base["k1"], base["k2"])):
        raise AssertionError(f"ep_avhubert_main_path: K1/K2 a step {per_step}, totals "
                             f"{ep['k1']}/{ep['k2']} against {base['k1']}/{base['k2']}")
    return {"k1": ep["k1"], "k2": ep["k2"]}


# the pipelined Whisper encoder (train/pp.py) at large-v2 widths on a 1 x 1
# (data, stage) mesh: the forward at batch PP_BATCH in PP_MICRO
# microbatches, then PP_STEPS train steps at batch PP_TRAIN_BATCH in
# PP_TRAIN_MICRO microbatches against the unpipelined step on the same
# weights; 30 s of mel an item
PP_BATCH, PP_MICRO = 8, 4
PP_TRAIN_BATCH, PP_TRAIN_MICRO, PP_STEPS = 4, 2, 3
PP_LR = 1e-5
PP_LOSS_RTOL, PP_GRAD_REL_L2 = 1e-3, 1e-2


class EncoderClassifier(torch.nn.Module):
    """A Whisper encoder, mean pooling over T and a [d, V] head: JAX's
    ``tests/test_pp_train.py::_sandwich`` with the encoder as its trunk.
    With ``pp`` the encoder's stem modules are kept and its blocks stacked
    into a ``StackedBlocks`` that ``whisper_encoder_pp_forward`` pipelines
    over ``mesh``'s stages; else the encoder runs as it is."""

    def __init__(self, cfg, encoder, head: torch.Tensor, pp: bool):
        from avsl_tpu_torch.core.pipeline import StackedBlocks
        from avsl_tpu_torch.train import split_whisper_encoder_params

        super().__init__()
        self.cfg = cfg
        self.head = torch.nn.Parameter(head)
        if pp:
            stacked, stem = split_whisper_encoder_params(encoder, cfg.n_audio_layer)
            self.stem = torch.nn.ModuleDict({k: getattr(encoder, k) for k in sorted(stem)})
            self.blocks = StackedBlocks(encoder.blocks[0], stacked)
        else:
            self.encoder = encoder

    def features(self, mel, mesh=None, n_microbatches: int = 1):
        from avsl_tpu_torch.train import whisper_encoder_pp_forward

        if not hasattr(self, "blocks"):
            return self.encoder(mel)
        stem = {k: dict(m.named_parameters()) for k, m in self.stem.items()}
        return whisper_encoder_pp_forward(self.cfg, stem, self.blocks, mel, mesh=mesh,
                                          n_microbatches=n_microbatches)

    def forward(self, mel, mesh=None, n_microbatches: int = 1):
        return self.features(mel, mesh, n_microbatches).float().mean(1) @ self.head


def unpipelined_names(named: dict) -> dict:
    """A pipelined ``EncoderClassifier``'s tensors under the unpipelined
    one's names, each stacked block tensor split into its layers."""
    out = {}
    for name, t in named.items():
        if name.startswith("blocks."):
            out.update({f"encoder.blocks.{i}.{name[7:]}": t[i] for i in range(t.shape[0])})
        else:
            out[name.replace("stem.", "encoder.", 1)] = t
    return out


def chunked_encoder(enc, mel, n_chunks: int):
    """``WhisperEncoder``'s forward with its blocks run on ``n_chunks``
    row chunks in turn: the stem and ``ln_post`` on the whole batch, as
    the pipelined forward runs them."""
    import torch.nn.functional as F

    x = F.gelu(enc.conv1(mel.to(enc.conv1.compute_dtype)))
    x = F.gelu(enc.conv2(x)).transpose(1, 2)
    x = x + enc.positional_embedding[: x.shape[1]]
    parts = []
    for h in x.split(x.shape[0] // n_chunks):
        for block in enc.blocks:
            h, _ = block(h)
        parts.append(h)
    return enc.ln_post(torch.cat(parts))


def phase_pp_whisper_main_path(card: str) -> dict:
    """Pipeline parallelism (``core/pipeline.py``, ``train/pp.py``) at
    large-v2's encoder widths (32 blocks of 1280, 20 heads, 1500 frames,
    bf16 compute on fp32 weights, seeded random weights) in a process
    group of one rank over NCCL, on ``make_pp_mesh(1, stages=1)``: the
    card holds one H100, so a stage axis above 1 runs only on gloo ranks
    (``mesh_cpu_ranks``). (1) ``whisper_encoder_pp_forward`` on PP_BATCH
    items of 30 s in PP_MICRO microbatches: bit-equal to the unpipelined
    blocks run on the same row chunks (:func:`chunked_encoder`), within
    BF16_TOL of the whole-batch encoder, 32 K1 a microbatch. (2) The
    encoder with a pooled [1280, 51865] head (:class:`EncoderClassifier`)
    through ``shard_pp_state``, ``ClippedAdamW`` and ``make_train_step``,
    PP_STEPS steps at batch PP_TRAIN_BATCH in PP_TRAIN_MICRO microbatches
    against the unpipelined step on the same weights, under
    ``torch.use_deterministic_algorithms``: every loss within PP_LOSS_RTOL,
    step 1's gradients within a relative L2 of PP_GRAD_REL_L2 per tensor,
    32 K1 and 32 K2 a microbatch (the schedule keeps each microbatch's
    graph, so the backward recomputes nothing). (3) ``save_checkpoint`` of
    the pp state read back into the unpipelined model: the same tensors.
    Every launch shape is held against the plain version. Logs peak
    memory."""
    import copy
    import os

    import torch.distributed as dist
    import torch.nn.functional as F

    from avsl_tpu_torch.core.pipeline import make_pp_mesh
    from avsl_tpu_torch.kernels import attention
    from avsl_tpu_torch.models import build_whisper_flamingo
    from avsl_tpu_torch.train import TrainState, make_train_step, shard_pp_state
    from avsl_tpu_torch.train.checkpoints import save_checkpoint
    from avsl_tpu_torch.train.optim import ClippedAdamW

    model, cfg = build_whisper_flamingo("large-v2", add_gated_x_attn=0,
                                        use_av_hubert_encoder=False, dtype="bfloat16",
                                        param_dtype="float32", device="cuda", seed=7)
    enc = model.encoder
    del model
    free_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    head = 0.02 * torch.randn(cfg.n_audio_state, LARGE_V2_VOCAB, device="cuda", generator=gen)
    base = EncoderClassifier(cfg, copy.deepcopy(enc), head.clone(), pp=False)
    pp = EncoderClassifier(cfg, enc, head, pp=True)
    del enc, head
    free_cuda()
    layers = cfg.n_audio_layer
    mel = torch.randn(PP_BATCH, cfg.n_mels, 2 * cfg.n_audio_ctx, device="cuda", generator=gen)
    labels = torch.randint(0, LARGE_V2_VOCAB, (PP_STEPS, PP_TRAIN_BATCH), device="cuda",
                           generator=gen)
    train_mel = torch.randn(PP_STEPS, PP_TRAIN_BATCH, cfg.n_mels, 2 * cfg.n_audio_ctx,
                            device="cuda", generator=gen)
    rec = {"phase": "pp_whisper_main_path", "card": card, "layers": layers,
           "width": cfg.n_audio_state, "heads": cfg.n_audio_head,
           "frames": cfg.n_audio_ctx, "params": sum(p.numel() for p in pp.parameters())}
    seen: list = []
    cudnn_deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
                                rank=0, world_size=1)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            mesh = make_pp_mesh(1, stages=1)
            rec["mesh"] = dict(mesh.shape)
            with torch.no_grad():
                with recorded(True, seen):
                    pp_out, fwd_k1, _, fwd_k2 = run_counted(
                        lambda: pp.features(mel, mesh, PP_MICRO))
                chunked = chunked_encoder(base.encoder, mel, PP_MICRO)
                whole = base.encoder(mel)
            rec["forward"] = {
                "batch": PP_BATCH, "microbatches": PP_MICRO, "k1": fwd_k1,
                "k2": fwd_k2, "bit_equal_to_chunked": bool(torch.equal(pp_out, chunked)),
                "max_abs_diff_chunked": float((pp_out.float() - chunked.float()).abs().max()),
                "max_abs_err_whole": float((pp_out.float() - whole.float()).abs().max()),
                "finite": bool(torch.isfinite(pp_out).all())}
            fwd_ok = torch.allclose(pp_out.float(), whole.float(), **BF16_TOL)
            del pp_out, chunked, whole
            if not (rec["forward"]["bit_equal_to_chunked"] and fwd_ok and rec["forward"]["finite"]
                    and fwd_k1 == layers * PP_MICRO and fwd_k2 == 0):
                raise AssertionError(f"pp_whisper_main_path forward: {rec['forward']}")

            def loss_of(m):  # the unpipelined encoder ignores the mesh
                def loss_fn(batch, _gen):
                    return F.cross_entropy(m(batch["mel"], mesh, PP_TRAIN_MICRO),
                                           batch["labels"]), {}
                return loss_fn

            variants, grads = {}, {}
            for name, m in (("pp", pp), ("unpipelined", base)):
                opt = ClippedAdamW(dict(m.named_parameters()), lambda c: PP_LR)
                state = TrainState.create(m, opt)
                if name == "pp":
                    shard_pp_state(state, mesh)
                step = make_train_step(loss_of(m), mesh=mesh if name == "pp" else None)
                inner = opt.step

                def capture(g, norm=None, inner=inner, name=name, opt=opt):
                    if name not in grads:  # step 1's gradients, before the clip
                        grads[name] = {n: t.detach().clone() for n, t in zip(opt.names, g)}
                    return inner(g, norm)

                opt.step = capture
                torch.cuda.reset_peak_memory_stats()
                attention.fused_attention.launches = attention.fused_attention_bwd.launches = 0
                steps = []
                for i in range(PP_STEPS):
                    batch = {"mel": train_mel[i], "labels": labels[i]}
                    k1 = attention.fused_attention.launches
                    k2 = attention.fused_attention_bwd.launches
                    launches = []
                    with recorded(name == "pp", launches):
                        state, metrics = step(state, batch)
                        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
                    seen += launches
                    steps.append({"loss": loss, "grad_norm": norm,
                                  "k1": attention.fused_attention.launches - k1,
                                  "k2": attention.fused_attention_bwd.launches - k2})
                opt.step = inner
                totals = (attention.fused_attention.launches,
                          attention.fused_attention_bwd.launches)
                variants[name] = {"k1": totals[0], "k2": totals[1], "steps": steps,
                                  "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
                if name == "pp":
                    pp_state = state
            rec["train"] = variants
            pp_steps, base_steps = variants["pp"]["steps"], variants["unpipelined"]["steps"]
            loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(pp_steps, base_steps)]
            pp_grads = unpipelined_names(grads["pp"])
            grad_rel = {n: float((pp_grads[n].float() - g.float()).norm()
                                 / g.float().norm().clamp_min(1e-30))
                        for n, g in grads["unpipelined"].items()}
            del grads, pp_grads
            worst = max(grad_rel, key=grad_rel.get)
            rec["loss_rel_err"] = loss_rel
            rec["grad_rel_l2_worst"] = {"tensor": worst, "value": grad_rel[worst],
                                        "tensors": len(grad_rel)}
            per_step = [(s["k1"], s["k2"]) for s in pp_steps]
            if (max(loss_rel) > PP_LOSS_RTOL or grad_rel[worst] > PP_GRAD_REL_L2
                    or set(grad_rel) != set(unpipelined_names(dict(pp.named_parameters())))
                    or per_step != [(layers * PP_TRAIN_MICRO,) * 2] * PP_STEPS
                    or not all(math.isfinite(s["loss"]) for s in pp_steps)):
                raise AssertionError(f"pp_whisper_main_path train: losses {loss_rel}, gradient "
                                     f"{worst} {grad_rel[worst]}, K1/K2 a step {per_step}")

            ckpt = os.path.join(tmp, "ckpt")
            path = save_checkpoint(ckpt, pp_state, pp_state.step)
            rec["checkpoint_bytes"] = os.path.getsize(path)
            saved = torch.load(path, map_location="cuda", weights_only=True)["model"]
            os.remove(path)
            logical = unpipelined_names(saved)
            own = base.state_dict()
            missing = sorted(set(own) - set(logical) - {"encoder.positional_embedding"})
            base.load_state_dict({**logical, "encoder.positional_embedding":
                                  own["encoder.positional_embedding"]})
            named = unpipelined_names(dict(pp.named_parameters()))
            differ = [n for n, p in base.named_parameters() if not torch.equal(p, named[n])]
            rec["checkpoint_round_trip"] = {"missing": missing, "differing": differ[:5],
                                            "tensors": len(named)}
            del saved, logical
            if missing or differ:
                raise AssertionError(f"pp_whisper_main_path checkpoint: {missing[:3]} {differ[:3]}")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn_deterministic
            dist.destroy_process_group()
    rec["shapes_checked"] = check_launch_shapes(seen)
    log(rec)
    return {"forward": fwd_k1, "train_k1": variants["pp"]["k1"],
            "train_k2": variants["pp"]["k2"]}


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_cpu_train(state_path: str, batch, mesh_kw) -> dict:
    """The tiny Whisper-Flamingo of ``state_path`` trained 2 steps of 2
    micro-batches on ``batch`` under the Flamingo regime (Whisper dropout
    0.1 and the tiny tower's rates), on a mesh from ``mesh_kw`` (None:
    one process; ``sp``: the steps' ``sequence_parallel``), then the eval
    step on the first micro-batch: losses, the eval loss, the trained
    tensors whole and the sequence splits the steps made."""
    from avsl_tpu_torch.core import mesh as mesh_mod
    from avsl_tpu_torch.core.config import FlamingoTrainConfig
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.core.partitioning import shard_state
    from avsl_tpu_torch.models import build_whisper_flamingo
    from avsl_tpu_torch.train import TrainState, flamingo_loss_fn, make_eval_step
    from avsl_tpu_torch.train import make_train_step, select_optimizer

    model, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                      param_dtype="float32", device="cpu", dropout_rate=0.1)
    model.load_state_dict(torch.load(state_path, weights_only=True))
    opt, labels = select_optimizer(model, FlamingoTrainConfig(
        add_gated_x_attn=1, learning_rate=1e-3, warmup_steps=1, num_train_steps=10), 10)
    state, mesh = TrainState.create(model, opt, seed=3), None
    if mesh_kw is not None:
        mesh = make_mesh(2, model_parallel=mesh_kw["mp"])
        shard_state(state, mesh, zero1=mesh_kw.get("zero1", False),
                    fsdp=mesh_kw.get("fsdp", False))
    sp = (mesh_kw or {}).get("sp")
    step = make_train_step(flamingo_loss_fn(model, train=True, spec_augment="ls-basic",
                                            prob_av=1.0, prob_a=0.5),
                           mesh=mesh, grad_accum_steps=2, param_labels=labels,
                           sequence_parallel=sp)
    splits = [0]
    scatter = mesh_mod.SequenceSplit.scatter

    def counted(self, x):
        splits[0] += 1
        return scatter(self, x)

    mesh_mod.SequenceSplit.scatter = counted
    try:
        losses = []
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        evaluate = make_eval_step(flamingo_loss_fn(model, train=False), mesh=mesh,
                                  sequence_parallel=sp)
        eval_loss = float(evaluate(state, {k: v[0] for k, v in batch.items()})["loss"])
    finally:
        mesh_mod.SequenceSplit.scatter = scatter
    named = dict(model.named_parameters())
    whole = {n: (named[n].detach() if state.layout is None else state.layout.full(n, named[n]))
             for n in opt.names}
    return {"loss": losses, "eval_loss": eval_loss, "splits": splits[0],
            "trained": {n: t.numpy().copy() for n, t in whole.items()}}


def _mesh_cpu_moe(state_path: str, rows, ep) -> dict:
    """The tiny CTC AV-HuBERT with MoE of ``state_path`` (MESH_CPU_MOE_CF)
    trained 2 steps on ``rows`` (two global batches of 4) with the
    fine-tune CLI's optimizer and the CTC loss plus the balance loss, then
    the eval step on the first batch, on ``make_ep_mesh(2, ep)`` (None:
    one process): losses, grad norms, the eval loss, the balance losses and
    the trained tensors whole."""
    from avsl_tpu_torch.cli.avhubert_ft import ctc_batch, make_optimizer
    from avsl_tpu_torch.core.config import AVHuBERTConfig
    from avsl_tpu_torch.models import build_avhubert
    from avsl_tpu_torch.models.moe import make_ep_mesh
    from avsl_tpu_torch.train import TrainState, make_eval_step, make_train_step
    from avsl_tpu_torch.train.objectives import avhubert_ctc_loss_fn

    cfg = AVHuBERTConfig.tiny_test(dtype="float32", n_experts=4,
                                   moe_capacity_factor=MESH_CPU_MOE_CF)
    model = build_avhubert(cfg, "ctc", device="cpu")
    model.load_state_dict(torch.load(state_path, weights_only=True))
    mesh = None if ep is None else make_ep_mesh(2, experts_parallel=ep)
    state = TrainState.create(model, make_optimizer(model, MESH_CPU_MOE_LR, 10), seed=2)
    step = make_train_step(avhubert_ctc_loss_fn(model), mesh=mesh)
    batches = [ctc_batch(b, cfg.pad_token_id) for b in rows]
    losses, norms, auxes = [], [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxes.append(float(m["moe_aux"]))
    eval_loss = float(make_eval_step(avhubert_ctc_loss_fn(model, train=False), mesh=mesh)(
        state, batches[0])["loss"])
    named = dict(model.named_parameters())
    whole = {n: (p.detach() if state.layout is None else state.layout.full(n, p))
             for n, p in named.items()}
    return {"loss": losses, "grad_norm": norms, "moe_aux": auxes, "eval_loss": eval_loss,
            "trained": {n: t.numpy().copy() for n, t in whole.items()},
            "split": [] if state.layout is None else sorted(state.layout.tp)}


def _mesh_cpu_serve(state_path: str, items, mp) -> list:
    """The tiny Whisper-Flamingo of ``state_path`` serving ``items``
    through ``StreamingTranscriber`` at MESH_CPU_SERVE_KW, on a mesh of
    the 2 ranks with a model axis of ``mp`` (None: one process):
    ``(id, tokens, avg_logprob)`` per item."""
    from avsl_tpu_torch.core.mesh import make_mesh
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.infer import StreamingTranscriber
    from avsl_tpu_torch.models import build_whisper_flamingo

    model, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                      param_dtype="float32", device="cpu",
                                      vocab_size=ByteTokenizer().add_tokens(["<laugh>"]))
    model.load_state_dict(torch.load(state_path, weights_only=True))
    tr = StreamingTranscriber(model.eval(), ByteTokenizer(), **MESH_CPU_SERVE_KW,
                              mesh=None if mp is None else make_mesh(2, model_parallel=mp))
    return [(r.id, list(r.tokens), r.avg_logprob) for r in tr.transcribe(items)]


def _mesh_cpu_pp(state_path: str, mel, labels, stages) -> dict:
    """The tiny fp32 Whisper encoder of ``state_path`` with its pooled head
    (:class:`EncoderClassifier`) on ``make_pp_mesh(2, stages)`` (None: one
    process, unpipelined): its features on ``mel[0]``, then 2 train steps
    on ``(mel[i], labels[i])`` (``ClippedAdamW`` at MESH_CPU_MOE_LR), each
    in 2 microbatches: the features, losses and trained tensors whole,
    under the unpipelined names."""
    import torch.nn.functional as F

    from avsl_tpu_torch.core.config import WhisperConfig
    from avsl_tpu_torch.core.pipeline import make_pp_mesh
    from avsl_tpu_torch.models.whisper import WhisperEncoder
    from avsl_tpu_torch.train import TrainState, make_train_step, shard_pp_state
    from avsl_tpu_torch.train.optim import ClippedAdamW

    cfg = WhisperConfig.tiny_test(dtype="float32", param_dtype="float32")
    saved = torch.load(state_path, weights_only=True)
    enc = WhisperEncoder(cfg, device="cpu")
    enc.load_state_dict({k[len("encoder."):]: v for k, v in saved.items() if k != "head"})
    model = EncoderClassifier(cfg, enc, saved["head"], pp=stages is not None)
    mesh = None if stages is None else make_pp_mesh(2, stages=stages)
    with torch.no_grad():
        features = model.features(torch.from_numpy(mel[0]), mesh, 2).numpy()
    opt = ClippedAdamW(dict(model.named_parameters()), lambda count: MESH_CPU_MOE_LR)
    state = TrainState.create(model, opt)
    if mesh is not None:
        shard_pp_state(state, mesh)
    step = make_train_step(lambda b, _gen: (F.cross_entropy(model(b["mel"], mesh, 2),
                                                            b["labels"]), {}), mesh=mesh)
    losses = []
    for i in range(len(mel)):
        state, metrics = step(state, {"mel": mel[i], "labels": labels[i]})
        losses.append(float(metrics["loss"]))
    whole = {n: (p.detach() if state.layout is None else state.layout.full(n, p))
             for n, p in model.named_parameters()}
    return {"features": features, "loss": losses,
            "trained": {n: t.numpy().copy() for n, t in unpipelined_names(whole).items()},
            "split": [] if state.layout is None else sorted(state.layout.tp)}


def _mesh_cpu_rank(rank: int, init_file: str, queue, state_path: str, batch, serve_path: str,
                   items, moe_path: str, moe_rows, pp_case) -> None:
    """One gloo rank of ``phase_mesh_cpu_ranks`` (spawned; CPU only)."""
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=2)
        try:
            out = {name: _mesh_cpu_train(state_path, batch, kw)
                   for name, kw in MESH_CPU_VARIANTS.items()}
            out["serve"] = {name: _mesh_cpu_serve(serve_path, items, mp)
                            for name, mp in MESH_CPU_SERVE.items()}
            out["moe"] = {name: _mesh_cpu_moe(moe_path, moe_rows, ep)
                          for name, ep in MESH_CPU_MOE.items()}
            out["pp"] = _mesh_cpu_pp(*pp_case, MESH_CPU_STAGES)
            queue.put((rank, out))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 (relayed to the parent, which raises)
        queue.put((rank, traceback.format_exc()))


def phase_mesh_cpu_ranks(card: str) -> dict:
    """The mesh over 2 gloo ranks on this machine's host CPU (spawned, a
    ``file://`` rendezvous): the tiny Whisper-Flamingo at dp 2
    replicated, ZeRO-1 and FSDP and at dp 1 x mp 2 with sequence
    parallelism (the encoders' activations split over T), each 2 steps and
    an eval step equal to one process's (MESH_CPU_TOL; dropout, SpecAugment
    and the AV-mode draw on, which the ranks draw as one process does);
    the tiny transcriber at mp 2 and at dp 2 against one process (tokens
    equal, MESH_CPU_LOGPROB_TOL); meanwhile ``python -m
    torch.distributed.run --standalone --nproc_per_node 2 -m
    avsl_tpu_torch.cli.finetune cfg.yaml --smoke --device cpu`` with
    ``num_devices: 2`` and ZeRO-1 (rc 0, one ``done:`` line, each metrics
    line once, the checkpoints) and ``-m avsl_tpu_torch.cli.transcribe
    --smoke --device cpu --model_parallel 2`` on four wavs (rc 0, one
    output file of four rows, written by rank 0). Expert parallelism: the
    tiny CTC AV-HuBERT with 4 experts of top 2 at capacity factor
    MESH_CPU_MOE_CF (capacity binds) at (data 2, expert 1) and (data 1,
    expert 2), 2 steps and an eval step equal to one process's
    (MESH_CPU_TOL; the key biases MESH_CPU_KEY_BIAS_ATOL), and ``-m
    avsl_tpu_torch.cli.pretrain --smoke --device cpu --n_experts 4
    --experts_parallel 2`` under the launcher (rc 0, one printed result,
    its ``mesh`` ``{"data": 1, "expert": 2}``). Pipeline parallelism: the
    tiny encoder with a pooled head (:class:`EncoderClassifier`) over the
    2 ranks as MESH_CPU_STAGES stages, its features and 2 steps equal to
    one process's unpipelined run (MESH_CPU_TOL)."""
    import json as json_mod
    import multiprocessing as mp
    import os

    import scipy.io.wavfile as wavfile

    from avsl_tpu_torch.cli import finetune
    from avsl_tpu_torch.cli.avhubert_ft import collate_av, make_synthetic_av_batchset
    from avsl_tpu_torch.core.config import AVHuBERTConfig, WhisperConfig
    from avsl_tpu_torch.data.tokenizer import ByteTokenizer
    from avsl_tpu_torch.models import build_avhubert, build_whisper_flamingo

    w_cfg = WhisperConfig.tiny_test()
    rng = np.random.default_rng(11)
    labels = rng.integers(0, w_cfg.n_vocab, size=(2, 4, 6))
    labels[..., 4:] = -100
    labels[:, 2:, 1:] = -100  # the second data rank holds fewer labels
    batch = {"input_ids": rng.normal(size=(2, 4, w_cfg.n_mels, 100)).astype(np.float32),
             "dec_input_ids": rng.integers(0, w_cfg.n_vocab, size=(2, 4, 6)),
             "labels": labels, "audio_frames": np.full((2, 4), 100),
             "video": rng.normal(size=(2, 4, 6, 48, 48, 1)).astype(np.float32),
             "video_mask": np.arange(6) < rng.integers(1, 7, size=(2, 4, 1))}
    items = [{"id": f"m{i}", "audio": (0.1 * rng.standard_normal(12000 + 1000 * i)).astype(
        np.float32)} for i in range(6)]
    items[1]["lip_feats"] = rng.standard_normal((20, 88, 88, 1), dtype=np.float32)
    moe_cfg = AVHuBERTConfig.tiny_test(dtype="float32", n_experts=4,
                                       moe_capacity_factor=MESH_CPU_MOE_CF)
    av_rows = make_synthetic_av_batchset(8, image=24, vocab=moe_cfg.vocab_size, seed=5)
    moe_rows = [collate_av(av_rows[i:i + 4], moe_cfg.pad_token_id) for i in (0, 4)]
    pp_mel = rng.normal(size=(2, 4, w_cfg.n_mels, 100)).astype(np.float32)
    pp_labels = rng.integers(0, 16, size=(2, 4))
    with tempfile.TemporaryDirectory() as tmp:
        # the launchers' ranks run beside the spawned ones (their TCP
        # stores on free localhost ports, the spawned ranks' a file)
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        for i in range(4):
            pcm = (0.1 * rng.standard_normal(16000)).astype(np.float32)
            wavfile.write(os.path.join(wav_dir, f"u{i}.wav"), 16000, pcm)
        run_dir = os.path.join(tmp, "cli")
        os.makedirs(run_dir)
        cfg_path = os.path.join(run_dir, "cfg.yaml")
        with open(cfg_path, "w") as f:
            f.write(f"num_devices: 2\ntrain_id: mesh\nlog_output_dir: {run_dir}/logs\n"
                    f"check_output_dir: {run_dir}/ckpt\nzero1: true\n")
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
            finetune.__file__))))
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": repo}
        cli = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "avsl_tpu_torch.cli.finetune", cfg_path, "--smoke", "--device", "cpu"],
            cwd=run_dir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        served = os.path.join(tmp, "transcripts.json")
        tr_cli = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "avsl_tpu_torch.cli.transcribe", "--smoke", "--device", "cpu",
             "--model_parallel", "2", "--input", wav_dir, "--output", served,
             "--batch_size", "2", "--max_new_tokens", "4"],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        pre_cli = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "avsl_tpu_torch.cli.pretrain", "--smoke", "--device", "cpu",
             "--n_experts", "4", "--experts_parallel", "2"],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            moe_path = os.path.join(tmp, "moe_state.pt")
            torch.save(build_avhubert(moe_cfg, "ctc", device="cpu", seed=4).state_dict(), moe_path)
            model, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                              param_dtype="float32", device="cpu", seed=5)
            set_gates(model, GATE)
            state_path = os.path.join(tmp, "state.pt")
            torch.save(model.state_dict(), state_path)
            model, _ = build_whisper_flamingo("test", add_gated_x_attn=1, dtype="float32",
                                              param_dtype="float32", device="cpu", seed=6,
                                              vocab_size=ByteTokenizer().add_tokens(["<laugh>"]))
            set_gates(model, GATE)
            serve_path = os.path.join(tmp, "serve_state.pt")
            torch.save(model.state_dict(), serve_path)
            model, _ = build_whisper_flamingo("test", add_gated_x_attn=0,
                                              use_av_hubert_encoder=False, dtype="float32",
                                              param_dtype="float32", device="cpu", seed=9)
            pp_path = os.path.join(tmp, "pp_state.pt")
            torch.save({**{f"encoder.{k}": v for k, v in model.encoder.state_dict().items()},
                        "head": 0.1 * torch.randn(w_cfg.n_audio_state, 16,
                                                  generator=torch.Generator().manual_seed(9))},
                       pp_path)
            pp_case = (pp_path, pp_mel, pp_labels)
            del model
            ctx = mp.get_context("spawn")
            queue = ctx.Queue()
            procs = [ctx.Process(target=_mesh_cpu_rank, daemon=True,
                                 args=(r, os.path.join(tmp, "rendezvous"), queue, state_path,
                                       batch, serve_path, items, moe_path, moe_rows,
                                       pp_case))
                     for r in range(2)]
            for p in procs:
                p.start()
            threads = torch.get_num_threads()
            torch.set_num_threads(2)
            try:
                single = _mesh_cpu_train(state_path, batch, None)
                single_served = _mesh_cpu_serve(serve_path, items, None)
                single_moe = _mesh_cpu_moe(moe_path, moe_rows, None)
                single_pp = _mesh_cpu_pp(*pp_case, None)
            finally:
                torch.set_num_threads(threads)
            ranks = dict(queue.get(timeout=300) for _ in procs)
            for p in procs:
                p.join(timeout=30)
            stdout, stderr = cli.communicate(timeout=300)
            tr_stdout, tr_stderr = tr_cli.communicate(timeout=300)
            pre_stdout, pre_stderr = pre_cli.communicate(timeout=300)
        finally:
            for proc in (cli, tr_cli, pre_cli):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if tr_cli.returncode != 0 or not os.path.exists(served):
            raise AssertionError(f"mesh_cpu_ranks: cli.transcribe rc {tr_cli.returncode}:\n"
                                 f"{tr_stdout[-2000:]}\n{tr_stderr[-2000:]}")
        with open(served) as f:
            transcripts = json_mod.load(f)
        printed = [line for line in tr_stdout.splitlines() if line.startswith("{")]
        if [r["id"] for r in transcripts] != [f"u{i}" for i in range(4)] or len(printed) != 4:
            raise AssertionError(f"mesh_cpu_ranks: cli.transcribe wrote {transcripts}, "
                                 f"printed {len(printed)} rows")
        for r, out in ranks.items():
            if isinstance(out, str):
                raise AssertionError(f"mesh_cpu_ranks: rank {r} failed:\n{out}")
        worst = {}
        for name in MESH_CPU_VARIANTS:
            for r in (0, 1):
                got = ranks[r][name]
                np.testing.assert_allclose(got["loss"], single["loss"], **MESH_CPU_TOL,
                                           err_msg=f"{name} rank {r}")
                for n, w in single["trained"].items():
                    np.testing.assert_allclose(got["trained"][n], w, **MESH_CPU_TOL,
                                               err_msg=f"{name} rank {r} {n}")
                np.testing.assert_allclose(got["eval_loss"], single["eval_loss"], **MESH_CPU_TOL,
                                           err_msg=f"{name} rank {r} eval")
            worst[name] = max(float(np.abs(ranks[r][name]["trained"][n] - w).max())
                              for r in (0, 1) for n, w in single["trained"].items())
        splits = {r: ranks[r]["dp1_mp2_sp"]["splits"] for r in (0, 1)}
        if not all(splits.values()) or single["splits"]:
            raise AssertionError(f"mesh_cpu_ranks: sequence splits {splits}, one process "
                                 f"{single['splits']}")
        for name in MESH_CPU_SERVE:
            for r in (0, 1):
                got = ranks[r]["serve"][name]
                if [g[:2] for g in got] != [w[:2] for w in single_served]:
                    raise AssertionError(f"mesh_cpu_ranks: transcriber {name} rank {r} tokens "
                                         "differ from one process's")
                np.testing.assert_allclose([g[2] for g in got], [w[2] for w in single_served],
                                           rtol=0, atol=MESH_CPU_LOGPROB_TOL,
                                           err_msg=f"transcriber {name} rank {r}")
        moe_worst = {}
        for name in MESH_CPU_MOE:
            for r in (0, 1):
                got, what = ranks[r]["moe"][name], f"moe {name} rank {r}"
                for key in ("loss", "grad_norm", "moe_aux", "eval_loss"):
                    np.testing.assert_allclose(got[key], single_moe[key], **MESH_CPU_TOL,
                                               err_msg=f"{what} {key}")
                for n, w in single_moe["trained"].items():
                    atol = MESH_CPU_KEY_BIAS_ATOL if n.endswith("k_proj.bias") else \
                        MESH_CPU_TOL["atol"]
                    np.testing.assert_allclose(got["trained"][n], w, rtol=MESH_CPU_TOL["rtol"],
                                               atol=atol, err_msg=f"{what} {n}")
            moe_worst[name] = max(float(np.abs(ranks[r]["moe"][name]["trained"][n] - w).max())
                                  for r in (0, 1) for n, w in single_moe["trained"].items()
                                  if not n.endswith("k_proj.bias"))
        for r in (0, 1):
            got, what = ranks[r]["pp"], f"pp stage rank {r}"
            np.testing.assert_allclose(got["features"], single_pp["features"], **MESH_CPU_TOL,
                                       err_msg=f"{what} features")
            np.testing.assert_allclose(got["loss"], single_pp["loss"], **MESH_CPU_TOL,
                                       err_msg=f"{what} loss")
            assert sorted(got["trained"]) == sorted(single_pp["trained"]), what
            for n, w in single_pp["trained"].items():
                np.testing.assert_allclose(got["trained"][n], w, **MESH_CPU_TOL,
                                           err_msg=f"{what} {n}")
            if not got["split"] or not all(n.startswith("blocks.") for n in got["split"]):
                raise AssertionError(f"mesh_cpu_ranks: {what} split {got['split']}")
        pp_worst = max(float(np.abs(ranks[r]["pp"]["trained"][n] - w).max())
                       for r in (0, 1) for n, w in single_pp["trained"].items())
        if ranks[0]["moe"]["dp2_ep1"]["split"] or not ranks[0]["moe"]["dp1_ep2"]["split"]:
            raise AssertionError("mesh_cpu_ranks: the expert leaves split "
                                 f"{ranks[0]['moe']['dp1_ep2']['split']}")
        pre_printed = [json_mod.loads(line) for line in pre_stdout.splitlines()
                       if line.startswith("{")]
        if pre_cli.returncode != 0 or len(pre_printed) != 1 \
                or pre_printed[0].get("mesh") != {"data": 1, "expert": 2}:
            raise AssertionError(f"mesh_cpu_ranks: cli.pretrain rc {pre_cli.returncode}, "
                                 f"printed {pre_printed}:\n{pre_stdout[-2000:]}\n"
                                 f"{pre_stderr[-2000:]}")
        if cli.returncode != 0:
            raise AssertionError(f"mesh_cpu_ranks: torch.distributed.run rc {cli.returncode}:\n"
                                 f"{stdout[-2000:]}\n{stderr[-2000:]}")
        lines = [json_mod.loads(line) for line in open(os.path.join(run_dir, "logs", "mesh",
                                                                    "metrics.jsonl"))]
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt", "mesh")))
        done = stdout.count("done: step=6")
        train_lines = [line["step"] for line in lines if "train/loss" in line]
        if done != 1 or train_lines != [6] or ckpts != ["best", "step_3.pt", "step_6.pt"]:
            raise AssertionError(f"mesh_cpu_ranks: {done} done lines, train lines {train_lines}, "
                                 f"checkpoints {ckpts}")
    log({"phase": "mesh_cpu_ranks", "card": card, "ranks": 2, "backend": "gloo",
         "variants": list(MESH_CPU_VARIANTS), "loss_single": single["loss"],
         "eval_loss_single": single["eval_loss"], "sequence_splits": splits,
         "trained_max_abs_diff": worst, "tolerance": MESH_CPU_TOL,
         "transcriber": {"variants": list(MESH_CPU_SERVE), "items": len(items),
                         "tokens_equal": True},
         "cli": {"done_lines": done, "checkpoints": ckpts,
                 "metrics_lines": len(lines)},
         "transcribe_cli": {"rows": len(transcripts), "printed": len(printed)},
         "moe": {"variants": list(MESH_CPU_MOE), "capacity_factor": MESH_CPU_MOE_CF,
                 "loss_single": single_moe["loss"], "moe_aux_single": single_moe["moe_aux"],
                 "eval_loss_single": single_moe["eval_loss"],
                 "expert_leaves_split": len(ranks[0]["moe"]["dp1_ep2"]["split"]),
                 "trained_max_abs_diff": moe_worst},
         "pretrain_cli": pre_printed[0],
         "pp": {"stages": MESH_CPU_STAGES, "loss_single": single_pp["loss"],
                "stage_leaves_split": len(ranks[0]["pp"]["split"]),
                "trained_max_abs_diff": pp_worst}})
    return worst


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

    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, together
        for future in [pool.submit(_build.load_library, name) for name in SOURCES]:
            future.result()
    log({"phase": "build", "sources": list(SOURCES)})
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    sass = sass_counts()
    log({"phase": "sass", "tensor_core_instructions": sass})

    cfg, tokenizer, train_batches, label_len = prepare_train_path(TRAIN_STEPS)
    fl_cfg, fl_tokenizer, fl_batches, fl_len = prepare_flamingo_path(TRAIN_STEPS)
    log({"phase": "prepare_train_paths", "label_len": label_len, "flamingo_label_len": fl_len})
    fwd_cases = phase_kernels(label_len, fl_len)
    phase_kernel_stats(fl_len)
    bwd_cases = phase_kernels_bwd(label_len, fl_len)
    phase_small_reference()
    phase_small_av_reference()
    phase_cached_attention()
    phase_small_train_reference()
    phase_small_flamingo_train_reference()
    phase_small_avhubert_reference()
    pre_small = phase_pretrain_small_reference(smi)
    phase_small_serving_reference()
    phase_resample(smi)

    phase_lip_frontend(smi)
    free_cuda()
    serving_launches, main_model = phase_main_path(smi)
    spec_launches = phase_serving_extras_spec(smi, main_model)
    del main_model
    free_cuda()
    export_launches = phase_serving_extras_export(smi)
    free_cuda()
    with tempfile.TemporaryDirectory() as out_dir:
        distill_launches = phase_distill(smi, out_dir)
    free_cuda()
    av_serving_launches, av_model, av_record = phase_av_main_path(smi)
    av_raw_launches = phase_av_raw_main_path(smi, *av_model)
    daemon_launches = phase_serving_daemon(smi, *av_model)
    mesh_serving_launches = phase_mesh_serving_main_path(smi, *av_model, av_record)
    with tempfile.TemporaryDirectory() as chain_dir:
        chain_records = phase_preprocess_chain(smi, chain_dir)
        eval_launches = phase_evaluate_main_path(smi, *av_model, chain_records)
    av_model = list(av_model)
    int8_launches = phase_serving_extras_int8(smi, av_model)
    free_cuda()
    with tempfile.TemporaryDirectory() as out_dir:
        train_launches = phase_train_main_path(smi, cfg, tokenizer, train_batches, out_dir)
        free_cuda()
        flamingo = {}
        for hoisted in (False, True):
            flamingo[hoisted] = phase_flamingo_train_main_path(smi, fl_cfg, fl_tokenizer,
                                                               fl_batches, out_dir, hoisted)
            free_cuda()
        mesh_launches = phase_mesh_train_main_path(smi, fl_cfg, fl_tokenizer, fl_batches, out_dir)
        free_cuda()
        pp_launches = phase_pp_whisper_main_path(smi)
        free_cuda()
        phase_mesh_cpu_ranks(smi)
        phase_multisteps_small(out_dir)
        job, dataset_launches = phase_flamingo_dataset_train(smi, out_dir)
        phase_prefetch(smi, job)
        del job
        free_cuda()
        job, lora_launches = phase_flamingo_lora_train(smi, out_dir)
        no_remat_launches = phase_remat_ab(smi, job)
        del job
        free_cuda()
    avh_cli = phase_avhubert_cli(smi)
    avh = phase_avhubert_train_main_path(smi)
    free_cuda()
    pre, pre_batch = phase_pretrain_main_path(smi)
    free_cuda()
    pre_moe = phase_pretrain_moe(smi, pre_batch)
    del pre_batch
    free_cuda()
    ep_launches = phase_ep_avhubert_main_path(smi)
    free_cuda()
    eval_smoke = phase_evaluate_cli_smoke(smi)
    avh_smoke = phase_avhubert_cli_smoke(smi)
    pre_smoke = phase_pretrain_cli_smoke(smi)
    free_cuda()
    avh_tools = phase_avh_tools_main_path(smi)
    free_cuda()
    avh_tiny = phase_avh_tools_card_vs_cpu(smi)
    phase_landmark_cnn(smi)
    doctor_launches = phase_doctor(smi)
    free_cuda()

    def entry(name, lib, source, replaces, cases, launches):
        case = cases[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(launches.values()), "launches_by_path": launches,
                "max_abs_err": case["max_abs_err"], "device_ms": case["kernel_device_ms"],
                "plain_device_ms": case["plain_device_ms"],
                "library_device_ms": case["library_device_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "shape": case["shape"], "dtype": case["dtype"],
                "sass": sass[lib],
                "device_ms_by_case": {c["case"]: c["kernel_device_ms"] for c in cases}}

    log({"kernels": [
        entry("flash_attention_fwd", "flash_attn_fwd", "avsl_tpu_torch/csrc/flash_attn_fwd.cu",
              "avsl_tpu/kernels/attention.py:63", fwd_cases,
              {"serving": serving_launches, "av_serving": av_serving_launches,
               "av_raw_serving": av_raw_launches, "serving_daemon": daemon_launches,
               "mesh_serving": mesh_serving_launches,
               "serving_int8": int8_launches["int8"] + int8_launches["int8_kv_int8"],
               "serving_kv_int8": int8_launches["kv_int8"],
               "speculative_tiny_draft": spec_launches["tiny_draft"],
               "speculative_self_draft": spec_launches["self_draft"],
               "exported_replay": export_launches,
               "training": train_launches["k1"],
               "flamingo_training": flamingo[False]["k1"],
               "flamingo_training_hoisted": flamingo[True]["k1"],
               "mesh_training": mesh_launches["k1"],
               "flamingo_dataset_training": dataset_launches["k1"],
               "flamingo_lora_training": lora_launches["k1"],
               "flamingo_lora_training_no_remat": no_remat_launches["k1"],
               "distill_labels": distill_launches["labels"],
               "distill_training": distill_launches["steps"],
               "speculative_distilled_draft": distill_launches["speculative"],
               "avhubert_cli_seq2seq": avh_cli["seq2seq"][0], "avhubert_cli_ctc": avh_cli["ctc"][0],
               "avhubert_training": avh["train"][0], "avhubert_eval": avh["eval"][0],
               "avhubert_ctc_eval": avh["ctc_eval"][0],
               "evaluate_teacher_forced": eval_launches["teacher_forced"],
               "evaluate_beam": eval_launches["beam"], "evaluate_cli_smoke": eval_smoke[0],
               "avhubert_cli_smoke": avh_smoke[0], "pretrain_small_reference": pre_small[0],
               "pretrain_training": pre["train"][0], "pretrain_eval": pre["eval"][0],
               "pretrain_relabel": pre["relabel"][0], "pretrain_moe_training": pre_moe["train"][0],
               "pretrain_moe_eval": pre_moe["eval"][0],
               "pretrain_moe_relabel": pre_moe["relabel"][0],
               "ep_avhubert_training": ep_launches["k1"],
               "pp_whisper_forward": pp_launches["forward"],
               "pp_whisper_training": pp_launches["train_k1"],
               **{name: counts[0] for name, counts in pre_smoke.items()},
               "avh_extract": avh_tools["extract"],
               "avh_extract_layer12": avh_tools["extract_layer12"],
               "avh_align": avh_tools["align"], "avh_tools_tiny": avh_tiny,
               "doctor_probe": doctor_launches}),
        entry("flash_attention_bwd", "flash_attn_bwd", "avsl_tpu_torch/csrc/flash_attn_bwd.cu",
              "avsl_tpu/kernels/attention.py:159", bwd_cases,
              {"serving": 0, "av_serving": 0, "av_raw_serving": 0, "serving_daemon": 0,
               "mesh_serving": 0,
               "serving_int8": 0, "serving_kv_int8": 0, "speculative_tiny_draft": 0,
               "speculative_self_draft": 0, "exported_replay": 0,
               "training": train_launches["k2"],
               "flamingo_training": flamingo[False]["k2"],
               "flamingo_training_hoisted": flamingo[True]["k2"],
               "mesh_training": mesh_launches["k2"],
               "flamingo_dataset_training": dataset_launches["k2"],
               "flamingo_lora_training": lora_launches["k2"],
               "flamingo_lora_training_no_remat": no_remat_launches["k2"],
               "distill_labels": 0, "distill_training": distill_launches["steps_k2"],
               "speculative_distilled_draft": 0,
               "avhubert_cli_seq2seq": avh_cli["seq2seq"][1], "avhubert_cli_ctc": avh_cli["ctc"][1],
               "avhubert_training": avh["train"][1], "avhubert_eval": avh["eval"][1],
               "avhubert_ctc_eval": avh["ctc_eval"][1],
               "evaluate_teacher_forced": 0, "evaluate_beam": 0,
               "evaluate_cli_smoke": eval_smoke[1], "avhubert_cli_smoke": avh_smoke[1],
               "pretrain_small_reference": pre_small[1], "pretrain_training": pre["train"][1],
               "pretrain_eval": pre["eval"][1], "pretrain_relabel": pre["relabel"][1],
               "pretrain_moe_training": pre_moe["train"][1],
               "pretrain_moe_eval": pre_moe["eval"][1],
               "pretrain_moe_relabel": pre_moe["relabel"][1],
               "ep_avhubert_training": ep_launches["k2"],
               "pp_whisper_forward": 0, "pp_whisper_training": pp_launches["train_k2"],
               **{name: counts[1] for name, counts in pre_smoke.items()},
               "avh_extract": 0, "avh_extract_layer12": 0, "avh_align": 0,
               "avh_tools_tiny": 0, "doctor_probe": 0}),
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
