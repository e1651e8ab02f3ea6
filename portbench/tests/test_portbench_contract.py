"""BENCHMARK.json against the rules it is written to, and every piece of a
cell found by name."""

import json
import re
import shutil

import pytest

from portbench import registry

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_portbench_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32 and BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_portbench_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    metric_names = [m["name"] for s in ("end_to_end", "per_layer") for m in BENCH[s]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_portbench_bounds_and_metric_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_portbench_cell_files_are_found_by_name(cell):
    w = registry.workload(cell)
    cfg = registry.config(w["config"])
    traffic = registry.traffic(w["traffic"])
    limits = registry.limits(cell)
    assert cfg["name"] == w["config"]
    assert hasattr(registry.driver(traffic["kind"]), "check")
    assert limits and all("limit" in v for v in limits.values())
    for m in registry.metrics_of(cell, "per_layer"):
        assert callable(registry.reader(m["name"]).read)
    assert w["chips"] in (1, 4)


def test_portbench_config_files_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()


def test_portbench_a_new_cell_needs_only_new_files(tmp_path):
    """A cell added as data: copies of a configuration, a traffic mix and a
    limits file under new names, listed in a new cell list; nothing that
    exists is edited."""
    files = tmp_path / "files"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(ROOT / "portbench" / sub, files / sub)
    cfg = json.loads((files / "configs" / "flamingo_large.json").read_text())
    cfg["name"] = "flamingo_large_copy"
    (files / "configs" / "flamingo_large_copy.json").write_text(json.dumps(cfg))
    shutil.copy(files / "traffic" / "transcribe_b64_t8.json",
                files / "traffic" / "transcribe_b16_t8.json")
    shutil.copy(files / "limits" / "flamingo_large.transcribe_b64_t8.json",
                files / "limits" / "flamingo_large_copy.transcribe_b16_t8.json")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "flamingo_large_copy.transcribe_b16_t8", "config": "flamingo_large_copy",
        "traffic": "transcribe_b16_t8", "chips": 1, "why": "a copy"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    saved = dict(registry.SOURCES)
    registry.SOURCES.update(benchmark=tmp_path / "BENCHMARK.json", files=files)
    try:
        w = registry.workload("flamingo_large_copy.transcribe_b16_t8")
        assert registry.config(w["config"])["name"] == "flamingo_large_copy"
        assert registry.traffic(w["traffic"])["kind"] == "transcribe"
        assert "logprob_gap" in registry.limits(w["name"])
        per_layer = [m["name"] for m in registry.metrics_of(w["name"], "per_layer")]
        assert "idle_share.train" not in per_layer
    finally:
        registry.SOURCES.update(saved)
