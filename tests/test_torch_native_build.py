"""The port's build of the shared host libraries under ``cpp/``
(``avsl_tpu_torch/utils/native_build.py``): six builders started at once
on a fresh directory, as six xdist workers or threads do, each load a
whole library afterwards; one ``make`` ran, and nothing was written into
``cpp/``."""

import ctypes
import os
import subprocess
import sys
import threading

import pytest

from avsl_tpu_torch.utils.native_build import NATIVE_DIR, ensure_built

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP = os.path.join(REPO, "cpp", "avsl_warp")
TARGET = "libavsl_warp.so"
N = 6

_ONE = """
import ctypes, os, sys
from avsl_tpu_torch.utils.native_build import ensure_built
path = ensure_built(sys.argv[1], sys.argv[2], out_dir=sys.argv[3])
ctypes.CDLL(path).avsl_sample_separable_f32
print(os.stat(path).st_ino)
"""


def _load(path):
    ctypes.CDLL(path).avsl_sample_separable_f32
    return os.stat(path).st_ino


def test_torch_native_build_default_dir():
    assert NATIVE_DIR == os.path.join(REPO, "build", "avsl_tpu_torch", "native")


@pytest.mark.parametrize("how", ["threads", "processes"])
def test_torch_native_build_concurrent(tmp_path, how):
    out_dir = str(tmp_path / "native")
    before = sorted(os.listdir(WARP))
    if how == "threads":
        inodes, errors = [], []
        barrier = threading.Barrier(N)

        def one():
            try:
                barrier.wait()
                inodes.append(_load(ensure_built(WARP, TARGET, out_dir=out_dir)))
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(e)

        threads = [threading.Thread(target=one) for _ in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
    else:
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen([sys.executable, "-c", _ONE, WARP, TARGET, out_dir], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(N)]
        outs = [p.communicate(timeout=300) for p in procs]
        assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
        inodes = [int(o[0]) for o in outs]
    # one build: every builder loaded the same renamed file, no temporary is left
    assert len(inodes) == N and len(set(inodes)) == 1
    assert os.listdir(out_dir) == [TARGET]
    assert sorted(os.listdir(WARP)) == before
