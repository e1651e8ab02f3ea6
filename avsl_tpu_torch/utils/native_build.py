"""Build-on-first-use for the shared host libraries under ``cpp/``.

Port of ``avsl_tpu/utils/native_build.py``. The ``.so`` files are build
outputs (git-ignored), so a fresh checkout has none: a loader calls
:func:`ensure_built` before it looks for its library, which runs ``make
-C <dir>`` once, quietly, with a time limit, when the library is missing
or older than its sources. A failed build is not fatal (the numpy and
OpenCV versions give the same results, slower); ``AVSL_NO_NATIVE_BUILD=1``
skips the attempt.
"""

from __future__ import annotations

import os
import subprocess
import sys


def ensure_built(src_dir: str, target: str, timeout_s: float = 180.0) -> None:
    """Run ``make`` in ``src_dir`` if ``target`` (relative to it) is
    missing or older than a source or the Makefile."""
    if os.environ.get("AVSL_NO_NATIVE_BUILD") == "1":
        return
    src_dir = os.path.abspath(src_dir)
    out = os.path.join(src_dir, target)
    try:
        sources = [
            os.path.join(src_dir, f)
            for f in os.listdir(src_dir)
            if f.endswith((".cpp", ".cc", ".c", ".h", ".hpp")) or f == "Makefile"
        ]
    except OSError:
        return
    if os.path.exists(out) and all(os.path.getmtime(out) >= os.path.getmtime(s) for s in sources):
        return
    try:
        r = subprocess.run(["make", "-C", src_dir], capture_output=True, text=True,
                           timeout=timeout_s)
        if r.returncode != 0:
            print(f"avsl_tpu_torch: native build in {src_dir} failed (rc={r.returncode}); "
                  f"using the slow fallback.\n{r.stderr[-2000:]}", file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"avsl_tpu_torch: native build in {src_dir} skipped ({e}); using the slow fallback.",
              file=sys.stderr)
