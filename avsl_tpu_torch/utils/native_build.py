"""Build-on-first-use for the shared host libraries under ``cpp/``.

Port of ``avsl_tpu/utils/native_build.py``. The ``.so`` files are build
outputs (git-ignored), so a fresh checkout has none: a loader calls
:func:`ensure_built` before it loads its library, which runs ``make -C
<dir>`` once, quietly, with a time limit, when the library is missing or
older than its sources. A failed build is not fatal (the numpy and OpenCV
versions give the same results, slower); ``AVSL_NO_NATIVE_BUILD=1`` skips
the attempt.

The port's copy of each library goes to ``build/avsl_tpu_torch/native/``
(git-ignored), never into ``cpp/``, which the JAX package builds in place.
Processes that build at once take an exclusive ``flock`` per library, and
``make`` writes to a temporary name (``TARGET=``, which overrides the
Makefile's ``:=``) that is renamed into place: a reader never sees a
half-written library.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import sys
import threading

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                          "build", "avsl_tpu_torch", "native")


@contextlib.contextmanager
def build_lock(target: str):
    """Exclusive lock on ``<NATIVE_DIR>/<target>.lock`` across processes
    and threads (each holder opens its own file description), whichever
    directory the library is built into."""
    os.makedirs(NATIVE_DIR, exist_ok=True)
    with open(os.path.join(NATIVE_DIR, f"{target}.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _stale(out: str, src_dir: str) -> bool:
    sources = [os.path.join(src_dir, f) for f in os.listdir(src_dir)
               if f.endswith((".cpp", ".cc", ".c", ".h", ".hpp")) or f == "Makefile"]
    return not os.path.exists(out) or any(os.path.getmtime(out) < os.path.getmtime(s) for s in sources)


def ensure_built(src_dir: str, target: str, out_dir: str = NATIVE_DIR,
                 timeout_s: float = 180.0) -> str:
    """Build ``target`` from the Makefile in ``src_dir`` into ``out_dir`` if
    it is missing or older than a source or the Makefile, under
    :func:`build_lock`; return its path (which need not exist if the build
    failed or was skipped)."""
    src_dir = os.path.abspath(src_dir)
    out = os.path.join(os.path.abspath(out_dir), target)
    if os.environ.get("AVSL_NO_NATIVE_BUILD") == "1" or not os.path.isdir(src_dir):
        return out
    with build_lock(target):
        if not _stale(out, src_dir):
            return out
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            r = subprocess.run(["make", "-C", src_dir, f"TARGET={tmp}"], capture_output=True,
                               text=True, timeout=timeout_s)
            if r.returncode == 0 and os.path.exists(tmp):
                os.replace(tmp, out)
            else:
                print(f"avsl_tpu_torch: native build in {src_dir} failed (rc={r.returncode}); "
                      f"using the slow fallback.\n{r.stderr[-2000:]}", file=sys.stderr)
        except (OSError, subprocess.TimeoutExpired) as e:
            print(f"avsl_tpu_torch: native build in {src_dir} skipped ({e}); using the slow fallback.",
                  file=sys.stderr)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out
