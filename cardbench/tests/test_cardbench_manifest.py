"""The manifest against the benchmark's contract, and the layout that lets
a later change add a configuration, a mix or a metric as files.

    python -m pytest cardbench/tests -q
"""
from __future__ import annotations

import json
import re
import shutil

import pytest

from cardbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.load_manifest()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(man):
    assert set(man) == TOP
    assert len(harness.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32
    assert all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128


def test_names_units_and_lines(man):
    every = (man["configs"] + man["workloads"] + man["end_to_end"]
             + man["per_layer"])
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names)), group
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in man["per_layer"]:
        assert _line(m["layer"])


def test_end_to_end_bounds(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_cells_report_what_their_layers_move(man):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, and every per-layer metric a cell reports moves an
    end-to-end metric that the cell reports."""
    for w in man["workloads"]:
        cell = harness.cell(w["name"], man)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_files_are_found_by_name(man):
    """Each cell's configuration, mix, driver and limits, and each
    per-layer metric's reader, exist under the names the manifest gives."""
    configs = {c["name"]: c for c in man["configs"]}
    for c in configs.values():
        assert c["file"].startswith("cardbench/")
        conf = json.loads((harness.CHECKOUT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
    for w in man["workloads"]:
        assert w["config"] in configs
        cell = harness.cell(w["name"], man)
        harness.load_module("drivers", cell["traffic"]["driver"])
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists()
    for m in man["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_dropped_file_is_found_with_no_edit(man, tmp_path, monkeypatch):
    """A new configuration, mix and metric added as files, and named in the
    manifest, are found by the harness with no edit to a file it has."""
    root = tmp_path / "cardbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((root / "configs" / "spheres-hole.json").read_text())
    conf.update(name="spheres-hole-small", width=64, height=64)
    (root / "configs" / "spheres-hole-small.json").write_text(
        json.dumps(conf))
    mix = json.loads((root / "traffic" / "frames.json").read_text())
    mix["check_lanes"] = 4096
    (root / "traffic" / "frames-light.json").write_text(json.dumps(mix))
    (root / "metrics" / "frames_seen.frame.py").write_text(
        "def read(t):\n    return float(len(t['summaries']))\n")
    new = json.loads(json.dumps(man))
    new["configs"].append(dict(
        name="spheres-hole-small", source="x",
        file="cardbench/configs/spheres-hole-small.json", reduced=[],
        why="x"))
    new["workloads"].append(dict(name="spheres-hole-small.frames-light",
                                 config="spheres-hole-small",
                                 traffic="frames-light", chips=1, why="x"))
    new["per_layer"].append(dict(name="frames_seen.frame", unit="frames",
                                 better="higher", source="device_trace",
                                 layer="device", moves="samples_per_s"))
    for m in new["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("spheres-hole-small.frames-light")
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(harness, "CHECKOUT", tmp_path)
    cell = harness.cell("spheres-hole-small.frames-light", new)
    assert cell["config"]["width"] == 64
    assert cell["traffic"]["check_lanes"] == 4096
    names = [m["name"] for m in cell["per_layer"]]
    assert "frames_seen.frame" in names
    reader = harness.load_module("metrics", "frames_seen.frame")
    assert reader.read({"summaries": [1, 2]}) == 2.0
