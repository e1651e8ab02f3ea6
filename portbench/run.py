"""Run one cell of the port's benchmark and print one JSON line.

Usage, from the root of a checkout, on a machine with the card(s):

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run makes its weights and inputs from ``--seed``, builds the program
(``avsl_tpu_torch``) and warms up the cell's shapes (set-up), measures for
``--seconds`` (traced by ``torch.profiler`` with ``--trace 1``), then
frees the program and holds what the window produced against the plain
reference (``portbench/reference``). It prints each number compared
beside its limit on standard error and, last on standard output,
``{"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
"checks"}``: the end-to-end metrics with ``--trace 0``, the per-layer
ones with ``--trace 1``. It exits non-zero with no result when the card
is missing, or when JAX or the JAX package was loaded.

``--control <name>`` runs what a check has to fail (the lower precision
or a planted fault, see ``drivers/``) in the program's place and prints
the same line; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "avsl_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``avsl_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--benchmark", default=None, help=argparse.SUPPRESS)
    p.add_argument("--files", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


class Context:
    """What a driver is given: the cell's entries and files, the seed, the
    device and the control (None in the benchmark's runs)."""

    def __init__(self, args, entry):
        from portbench import registry

        self.workload = entry["name"]
        self.cfg = registry.config(entry["config"])
        self.traffic = registry.traffic(entry["traffic"])
        self.limits = registry.limits(entry["name"])
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.device = args.device
        self.control = args.control


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import registry

    if args.benchmark:
        registry.SOURCES["benchmark"] = args.benchmark
    if args.files:
        registry.SOURCES["files"] = args.files

    try:
        entry = registry.workload(args.workload)
    except (KeyError, OSError) as e:
        fail(str(e))
    import torch

    from portbench import launches, trace

    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < int(entry["chips"])):
        fail(f"{args.workload} needs {entry['chips']} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    # one intra-op thread: a pool of them spins beside the thread that
    # launches the kernels (the Flamingo step ran 13-36 % faster with one
    # than with four on the H100's host, four pairs of runs)
    torch.set_num_threads(1)
    ctx = Context(args, entry)
    driver = registry.driver(ctx.traffic["kind"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    box, shapes = [], []
    with trace.traced(ctx.trace and cuda, box), launches.recorded(ctx.trace and cuda, shapes):
        win = driver.window(state, ctx.seconds)
    tr = box[0]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    checks = driver.check(state)
    del state
    gc.collect()
    # every request or row the window was given has come back, sound
    checks.append({"name": "failed", "value": int(win["failed"]), "limit": 0,
                   "at": f"of {int(win['attempted'])} attempted"})
    correct = all(c["value"] <= c["limit"] for c in checks)

    metrics = {}
    if not ctx.trace:
        values = dict(win["end_to_end"], setup_s=setup_s, peak_mem_gb=peak / 1e9)
        for m in registry.metrics_of(ctx.workload, "end_to_end"):
            if m["name"] not in values:
                fail(f"the {ctx.traffic['kind']} driver does not measure {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        with open(Path(__file__).parent / "peaks.json") as f:
            peaks = json.load(f)["NVIDIA H100"]
        rctx = {"trace": tr, "window": win, "launches": shapes, "cfg": ctx.cfg,
                "traffic": ctx.traffic, "peaks": peaks}
        for m in registry.metrics_of(ctx.workload, "per_layer"):
            value = registry.reader(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        device["power_limit"] = power_limit()
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    line = {"correct": bool(correct), "attempted": int(win["attempted"]),
            "failed": int(win["failed"]), "metrics": metrics, "device": device}
    if tr is not None:
        line["breakdown"] = tr.breakdown()
    if ctx.control is not None:
        line["control"] = ctx.control
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    found = forbidden_modules()
    if found:
        fail(f"loaded {', '.join(found)}: the benchmark and the port must not load JAX or "
             f"the JAX package", 3)
    if "ends_s" in win:
        print("window ends_s: " + " ".join(f"{t:.3f}" for t in win["ends_s"]), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} ({c.get('at', '')})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
