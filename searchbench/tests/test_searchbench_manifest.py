"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in MAN["paths"]), w
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = MAN[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section] and set(e) >= KEYS[section] - {
            "workloads"}, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                               "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs_are_files_under_paths():
    for c in MAN["configs"]:
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank"))
        assert body["reduced"] == c["reduced"]
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


def test_cells():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (ROOT / "searchbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MAN["workloads"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == configs


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "searchbench" / "metrics"
                / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):
            # the cell reports the end-to-end metric this one moves
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        per = [m for m in MAN["per_layer"] if w in m.get("workloads", [w])]
        top = [m for m in MAN["end_to_end"]
               if w in m.get("workloads", [w]) and m["name"] != "setup_s"]
        assert per and top


def test_layers_are_named_alike():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
