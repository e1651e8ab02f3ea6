"""Everything of one cell, found by name.

``BENCHMARK.json`` (beside this folder) names the cell's configuration,
traffic mix and metrics; each lives in a file of its own here:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<traffic>.json``: the parameters of the generator
  (:mod:`portbench.data`); its ``kind`` names the driver
  ``drivers/<kind>.py`` that runs it on the program;
* ``limits/<workload>.json``: each number the check compares, with its
  limit and the readings it was set from;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None when it finds nothing to read.

A later cell or metric is added by adding such files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# where the cell list and the data files are read from (a test points them
# at a tiny stand-in; drivers and readers always come from this folder)
SOURCES = {"benchmark": ROOT / "BENCHMARK.json", "files": HERE}


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(Path(SOURCES["benchmark"]))


def workload(name: str) -> Dict[str, Any]:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict[str, Any]:
    return _json(Path(SOURCES["files"]) / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return _json(Path(SOURCES["files"]) / "traffic" / f"{name}.json")


def limits(workload_name: str) -> Dict[str, Any]:
    return _json(Path(SOURCES["files"]) / "limits" / f"{workload_name}.json")


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def driver(kind: str) -> ModuleType:
    return _module(HERE / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def reader(metric: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{metric}.py", "portbench_metric_" + metric.replace(".", "_"))


def metrics_of(workload_name: str, section: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or that list no cells."""
    return [m for m in benchmark()[section]
            if "workloads" not in m or workload_name in m["workloads"]]
