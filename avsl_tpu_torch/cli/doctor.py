"""Environment preflight of the port: ``python -m avsl_tpu_torch.cli.doctor
[--config cfg.yaml] [--device cuda|cpu]``.

Port of ``avsl_tpu/cli/doctor.py``: checks are side-effect-free (the
kernel build writes only the port's build directory) and each prints
PASS/WARN/FAIL with a one-line consequence; the exit code is 1 only on
FAIL. The JAX checks map to the port's own:

* python dependencies: torch, numpy and PyYAML;
* torch device: a CUDA card and its name, or the CPU when ``--device cpu``
  asks for it (without a card and without ``--device cpu`` this FAILs);
* tiny compile + execute: a matmul on the device, then both attention
  kernels built from ``avsl_tpu_torch/csrc`` by ``kernels/_build.py``
  (``nvcc``) and one forward launch held to ``reference_attention``; on
  ``--device cpu`` the kernel half is skipped with a WARN naming the card
  they need;
* the native media decoder, the video IO chain and the landmark CNN's
  weights: WARN only (a card's host may have neither libav nor OpenCV);
* audio kernels: ``log_mel_spectrogram`` and ``logfbank`` on the device;
* ``--config``: the YAML loads and its output directories are writable.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Optional, Tuple

_RESULTS: List[Tuple[str, str, str]] = []  # (status, name, detail)
# the card the attention kernels are built for
KERNEL_CARD = "an NVIDIA Hopper card (sm_90a, e.g. H100) with nvcc"


class Skipped(Exception):
    """Raised by a check that cannot run here: recorded as a WARN."""


def _record(status: str, name: str, detail: str = "") -> None:
    _RESULTS.append((status, name, detail))
    line = f"[{status}] {name}"
    if detail:
        line += f" — {detail}"
    print(line)


def check(name: str, warn_only: bool = False):
    """Decorator: run the check, catch everything, record the outcome.
    The check returns a detail string (PASS) or raises (FAIL, or WARN when
    ``warn_only`` or the exception is :class:`Skipped`)."""

    def wrap(fn: Callable[[], Optional[str]]):
        def run():
            try:
                detail = fn() or ""
                _record("PASS", name, detail)
            except Exception as e:  # noqa: BLE001 — preflight must not crash
                warn = warn_only or isinstance(e, Skipped)
                _record("WARN" if warn else "FAIL", name, str(e))

        return run

    return wrap


def kernel_probe(device) -> str:
    """Both attention kernels built, then one forward launch (bf16, [1,
    64, 2, 64]) held to the plain version within ``BF16_TOL``."""
    import torch

    from avsl_tpu_torch.kernels._build import load_library
    from avsl_tpu_torch.kernels.attention import BF16_TOL, fused_attention, reference_attention

    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        load_library(name)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q, k, v = (torch.randn((1, 64, 2, 64), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    with torch.no_grad():
        got = fused_attention(q, k, v).float()
        want = reference_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   None, False).transpose(1, 2).float()
    err = (got - want).abs().max().item()
    if not bool(((got - want).abs() <= BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()).all()):
        raise RuntimeError(f"attention kernel differs from the plain version by {err:.3e}")
    return f"kernels built; attention launch within {err:.1e} of the plain version"


def main(argv: Optional[List[str]] = None) -> int:
    _RESULTS.clear()  # module-level accumulator: reset per invocation
    p = argparse.ArgumentParser(prog="avsl_tpu_torch.cli.doctor")
    p.add_argument("--config", default=None,
                   help="training YAML to validate (keys + output dirs)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    @check("python dependencies")
    def deps():
        import numpy
        import torch
        import yaml  # noqa: F401

        return f"torch {torch.__version__}, numpy {numpy.__version__}"

    @check("torch device")
    def device_check():
        import torch

        from avsl_tpu_torch.core.device import resolve_device

        dev = resolve_device(args.device)
        if dev.type == "cuda":
            return (f"{torch.cuda.device_count()} CUDA device(s): "
                    f"{torch.cuda.get_device_name(dev)}")
        return f"{dev} (--device {args.device})"

    @check("tiny compile + execute")
    def compile_probe():
        import torch

        from avsl_tpu_torch.core.device import resolve_device

        dev = resolve_device(args.device)
        x = torch.eye(8, device=dev)
        if float((x @ x.T).sum()) != 8.0:
            raise RuntimeError("matmul on the device gave a wrong result")
        if dev.type != "cuda":
            raise Skipped(f"matmul ok on {dev}; the attention kernels were not built: "
                          f"they need {KERNEL_CARD}")
        return "matmul ok; " + kernel_probe(dev)

    @check("native media decoder", warn_only=True)
    def native():
        from avsl_tpu_torch.data.media_native import native_available

        if not native_available():
            raise RuntimeError(
                "libavsl_media.so not built — video decode falls back to "
                "cv2 (slower, no thread-pool batching); build with "
                "`make -C cpp/avsl_media`"
            )
        return "libavsl_media.so loaded"

    @check("video IO fallback chain", warn_only=True)
    def video_io():
        import tempfile

        import numpy as np

        from avsl_tpu_torch.data.video_io import (
            read_video_frames,
            validate_video,
            write_video_frames,
        )

        # seeded noise, so the clip clears validate_video's minimum size
        # (the JAX probe's 4 black 32 x 32 frames never do: it always WARNs)
        frames = np.random.default_rng(0).integers(0, 256, (8, 64, 64), dtype=np.uint8)
        with tempfile.TemporaryDirectory() as d:
            path = write_video_frames(os.path.join(d, "probe.mp4"), frames, fps=25)
            ok, reason = validate_video(path)
            if not ok:
                raise RuntimeError(reason)
            back = read_video_frames(path, grayscale=True)
            if back.shape != frames.shape:
                raise RuntimeError(f"read back {back.shape}, wrote {frames.shape}")
        return "write/validate/read ok"

    @check("landmark detector assets", warn_only=True)
    def detector_assets():
        from avsl_tpu_torch.data.landmarks import DEFAULT_CNN_WEIGHTS

        if not os.path.exists(DEFAULT_CNN_WEIGHTS):
            raise RuntimeError(
                "landmark_cnn.npz missing — CNNLandmarkDetector will run "
                "random-initialized; train with "
                "`python -m avsl_tpu_torch.cli.train_landmarks`"
            )
        return os.path.basename(DEFAULT_CNN_WEIGHTS)

    @check("audio kernels")
    def audio():
        import numpy as np

        from avsl_tpu_torch.kernels.fbank import logfbank
        from avsl_tpu_torch.kernels.logmel import log_mel_spectrogram

        x = np.zeros(16000, np.float32)
        mel = log_mel_spectrogram(x, device=args.device)
        fb = logfbank(x, device=args.device)
        if mel.shape[0] != 80 or fb.shape[1] != 26:
            raise RuntimeError(f"mel {tuple(mel.shape)}, logfbank {tuple(fb.shape)}")
        return f"mel {tuple(mel.shape)}, logfbank {tuple(fb.shape)} on {mel.device}"

    deps()
    device_check()
    compile_probe()
    native()
    video_io()
    detector_assets()
    audio()

    if args.config:

        @check(f"config {os.path.basename(args.config)}")
        def config_check():
            from avsl_tpu_torch.core.config import load_yaml_config

            cfg = load_yaml_config(args.config)
            details = []
            for key in ("check_output_dir", "log_output_dir"):
                path = cfg.get(key)
                if path:
                    parent = os.path.dirname(os.path.abspath(str(path))) or "."
                    if not os.access(parent if os.path.isdir(parent) else ".", os.W_OK):
                        raise RuntimeError(f"{key}={path} not writable")
                    details.append(key)
            return "loads; writable: " + (", ".join(details) or "n/a")

        config_check()

    fails = [r for r in _RESULTS if r[0] == "FAIL"]
    warns = [r for r in _RESULTS if r[0] == "WARN"]
    print(f"\n{len(_RESULTS)} checks: {len(_RESULTS) - len(fails) - len(warns)}"
          f" pass, {len(warns)} warn, {len(fails)} fail")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
