"""Steady loads of the JAX package's native libraries in the port's tests.

The JAX loaders build ``cpp/<lib>`` in place with ``make``. Under xdist
another worker's ``make`` can leave a half-written library there, which
``ctypes.CDLL`` rejects ("file too short"), and the loaders'
``lru_cache`` keeps that failure for the rest of the worker's run.
:func:`load_jax_native` builds the library in ``cpp/`` to a temporary name
and renames it into place, under the port's lock for that library
(``avsl_tpu_torch.utils.native_build.build_lock``), then loads it through
the JAX loader under the same lock, clearing the loader's cache and
retrying while the file is half-written, within a bounded wait.
"""

import ctypes
import os
import time

from avsl_tpu_torch.utils.native_build import build_lock, ensure_built

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTIAL = ("file too short", "invalid ELF header", "ELF load command")


def _half_written(path):
    try:
        ctypes.CDLL(path)
    except OSError as e:
        return any(m in str(e) for m in PARTIAL)
    return False


def load_jax_native(module, lib, wait_s=120.0):
    """``module._load_lib()`` once ``cpp/<lib>/lib<lib>.so`` is whole:
    ``module`` is one of the JAX package's ctypes bindings and ``lib`` its
    directory under ``cpp/`` (``avsl_track``, ``avsl_warp``,
    ``avsl_media``)."""
    src = os.path.join(REPO, "cpp", lib)
    target = f"lib{lib}.so"
    path = ensure_built(src, target, out_dir=src)
    deadline = time.monotonic() + wait_s
    with build_lock(target):
        while True:
            module._load_lib.cache_clear()
            try:
                loaded = module._load_lib()
            except OSError as e:
                if not any(m in str(e) for m in PARTIAL) or time.monotonic() > deadline:
                    raise
            else:
                if (loaded is not None or not os.path.exists(path) or not _half_written(path)
                        or time.monotonic() > deadline):
                    return loaded
            time.sleep(0.2)
