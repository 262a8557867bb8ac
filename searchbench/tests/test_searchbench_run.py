"""Whole runs of every cell on the CPU at a small corpus (the kernels'
plain versions), and the command's refusals."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from searchbench import corpusgen, harness, load

ROOT = Path(__file__).resolve().parents[2]
MAN = harness.read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MAN["workloads"]]
SMALL = {"n_docs": 5000}


def quiet(_):
    pass


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct(cell):
    res = harness.run(cell, 2**31 + 3, 1.0, False, device="cpu",
                      overrides=SMALL, log=quiet)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in MAN["end_to_end"]}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"lost", "rank_gap", "id_gap"}
    json.dumps(res)


def test_a_traced_run_reports_its_layers():
    cell = "ell-2p25-c64"
    res = harness.run(cell, 77, 1.0, True, device="cpu", overrides=SMALL,
                      log=quiet)
    assert res["correct"]
    # on the CPU the device's metrics find nothing to read
    assert {"queue_wait_ms", "batch_size", "search_ms"} <= set(
        res["metrics"])
    assert not {"match_ms", "scan_roofline", "device_idle"} & set(
        res["metrics"])
    assert res["metrics"]["batch_size"]["value"] > 1
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]


@pytest.mark.parametrize("loop", ["open", "poisson", None])
def test_a_loop_the_harness_lacks_is_refused(loop):
    wl, cfg, traffic = harness.cell(CELLS[0])
    with pytest.raises(ValueError, match="loop"):
        load.loop({**traffic, "loop": loop})


def test_every_traffic_file_names_what_the_harness_drives():
    for w in MAN["workloads"]:
        _, _, traffic = harness.cell(w["name"])
        assert load.loop(traffic) is load.closed_loop
        assert traffic["queries"] in corpusgen.QUERY_KINDS


def test_clients_take_the_pool_in_one_order_whatever_the_seed():
    from concurrent.futures import Future
    import threading
    sent = {}

    def submit(q):
        sent.setdefault(threading.current_thread().name, []).append(q)
        f = Future()
        f.set_result(type("R", (), {"doc_ids": None, "scores": None}))
        return f
    res = load.closed_loop(submit, 40, 3, 0.05)
    slots = load.order(40)
    assert list(slots) != sorted(slots)      # sizes mixed in a batch
    assert res.attempted == sum(map(len, sent.values())) > 3
    for c in range(3):
        got = sent[f"searchbench-client-{c}"]
        assert got == [int(slots[(k * 3 + c) % 40]) for k in range(len(got))]


def test_buckets_are_those_the_traffic_reaches():
    _, ell, c64 = harness.cell("ell-2p25-c64")
    _, _, c1 = harness.cell("ell-2p25-c1")
    assert harness.buckets(ell, c64) == [1, 2, 4, 8, 16, 32]
    assert harness.buckets(ell, c1) == [1]


def _run_py(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "searchbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_refuses_in_a_copy_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "searchbench", tmp_path / "searchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
