"""The port stands alone: it imports no JAX, flax or avsl_tpu module (nor
OpenCV until a lip clip file is decoded), calls no library attention, and
chip_smoke.py refuses to run without a card."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import avsl_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "avsl_tpu_torch").rglob("*.py"))
FORBIDDEN_MODULES = ("jax", "flax", "avsl_tpu")
ALL_SUBMODULES = sorted(
    m.name for m in pkgutil.walk_packages(avsl_tpu_torch.__path__, "avsl_tpu_torch.")
)


# the serving daemon's modules: they copy what they need of the JAX
# package's host numpy (the DTW, the endpointer, the energy splitter, the
# biasing trie) instead of importing it
SERVING_MODULES = {
    "avsl_tpu_torch.decode.biasing", "avsl_tpu_torch.decode.language",
    "avsl_tpu_torch.decode.word_timestamps", "avsl_tpu_torch.infer.longform",
    "avsl_tpu_torch.infer.streaming", "avsl_tpu_torch.infer.server",
    "avsl_tpu_torch.cli.serve",
}


# int8 weights and cache, speculative decoding and the exported programs:
# their own copies of avsl_tpu/models/quant.py, decode/speculative.py and
# infer/export.py
SERVING_EXTRAS = {
    "avsl_tpu_torch.models.quant", "avsl_tpu_torch.decode.speculative",
    "avsl_tpu_torch.infer.export", "avsl_tpu_torch.cli.export_program",
}
# the training extras: their own copies of avsl_tpu/train/ema.py,
# models/lora.py, train/distill.py and their CLIs
TRAINING_EXTRAS = {
    "avsl_tpu_torch.train.ema", "avsl_tpu_torch.cli.avg_ckpt", "avsl_tpu_torch.models.lora",
    "avsl_tpu_torch.cli.export_lora", "avsl_tpu_torch.train.distill",
    "avsl_tpu_torch.cli.distill",
}

# evaluation and the reference's dataset layer: their own copies of
# avsl_tpu/data/{ami_xml,segments,video_segments,media_native,chunked,
# hf_dataset,dataset_process}.py and cli/{evaluate,preprocess}.py
DATASET_LAYER = {
    "avsl_tpu_torch.cli.evaluate", "avsl_tpu_torch.cli.preprocess",
    "avsl_tpu_torch.data.ami_xml", "avsl_tpu_torch.data.segments",
    "avsl_tpu_torch.data.video_segments", "avsl_tpu_torch.data.media_native",
    "avsl_tpu_torch.data.chunked", "avsl_tpu_torch.data.hf_dataset",
    "avsl_tpu_torch.data.dataset_process",
}


def test_torch_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['avsl_tpu_torch', *ALL_SUBMODULES]!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m == 'avsl_tpu' or m.startswith('avsl_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(ALL_SUBMODULES) >= 20
    # the dataset path's and the serving daemon's modules are among those imported
    assert {"avsl_tpu_torch.kernels.resample", "avsl_tpu_torch.data.batching",
            "avsl_tpu_torch.data.prefetch"} <= set(ALL_SUBMODULES)
    assert SERVING_MODULES <= set(ALL_SUBMODULES)
    assert SERVING_EXTRAS <= set(ALL_SUBMODULES)
    assert TRAINING_EXTRAS <= set(ALL_SUBMODULES)
    assert DATASET_LAYER <= set(ALL_SUBMODULES)


def test_torch_port_imports_no_cv2():
    """The card's machine has no OpenCV, pandas or ``datasets``: importing
    the port, the video tower, the lip-feature loader and the dataset
    layer included, must import none of them."""
    assert {"avsl_tpu_torch.models.resnet3d", "avsl_tpu_torch.models.avhubert",
            "avsl_tpu_torch.data.video_io"} | DATASET_LAYER <= set(ALL_SUBMODULES)
    code = (
        "import importlib, sys\n"
        f"for name in {ALL_SUBMODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('cv2', 'pandas', 'datasets') if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _violations(path: Path, allow_sdpa: bool):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            if name.split(".")[0] in FORBIDDEN_MODULES:
                found.append(f"import {name}")
        if isinstance(node, ast.Attribute) and node.attr == "scaled_dot_product_attention":
            if not allow_sdpa:
                found.append("scaled_dot_product_attention")
        if isinstance(node, ast.Name) and node.id in ("scaled_dot_product_attention", "jax"):
            found.append(node.id)
        if isinstance(node, ast.Attribute) and node.attr == "compile" and \
                isinstance(node.value, ast.Name) and node.value.id == "torch":
            found.append("torch.compile")
    return found


@pytest.mark.parametrize("path", PORT_FILES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_torch_port_source_names_no_jax_or_library_attention(path):
    # chip_smoke.py times scaled_dot_product_attention as a yardstick only
    assert _violations(path, allow_sdpa=path.name == "chip_smoke.py") == []


def test_torch_chip_smoke_fails_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:  # a directory that holds chip_smoke.py and nothing else
            script = tmp_path / "chip_smoke.py"
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
