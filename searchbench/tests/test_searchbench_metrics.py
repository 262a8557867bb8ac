"""Each per-layer metric reader, and the trace reading, on a recorded
synthetic trace."""
import json

import pytest

from repro_torch.obs import Obs
from repro_torch.serve.batcher import BatcherStats
from searchbench import harness, profread

# a window of 1000 us: two batches, each a copy in, a match kernel, a sort
# and a copy out, with host ops on the batcher thread between them
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "searchbench.search",
     "ts": 0.0, "dur": 420.0, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 5.0,
     "dur": 20.0, "tid": 1},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 10.0,
     "dur": 10.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": "void table_kernel<EllDocs>(...)",
     "ts": 30.0, "dur": 200.0, "tid": 7},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "searchbench.search",
     "ts": 10.0, "dur": 400.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": "sort_kernel", "ts": 250.0,
     "dur": 100.0, "tid": 7},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
     "ts": 360.0, "dur": 50.0, "tid": 1},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400.0,
     "dur": 5.0, "tid": 7},
    {"ph": "X", "cat": "user_annotation", "name": "searchbench.search",
     "ts": 500.0, "dur": 420.0, "tid": 1},
    {"ph": "X", "cat": "kernel", "name": "void table_kernel<EllDocs>(...)",
     "ts": 530.0, "dur": 200.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": "sort_kernel", "ts": 750.0,
     "dur": 100.0, "tid": 7},
    {"ph": "i", "name": "marker", "ts": 0.0},
]
CFG = {"match_kernel": ["table_kernel", "EllDocs"]}


def records(spans=None, busy_s=None, window_s=1000e-6, registry=None,
            stats=None, events=EVENTS):
    iv = profread.device_intervals(events)
    busy = profread.busy_us(iv) / 1e6 if busy_s is None else busy_s
    spans = ([(0.0, 0.00042, 32, 1e-4), (0.0005, 0.00092, 32, 1e-4)]
             if spans is None else spans)
    return harness.Records(CFG, iv, busy, window_s, spans, registry, stats)


def test_trace_reading(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    ev = profread.load(path)
    assert len(ev) == len(EVENTS) - 1          # complete events only
    iv = profread.device_intervals(ev)
    # the gpu_user_annotation is a label, not work
    assert [n for _, _, n in iv].count("searchbench.search") == 0
    assert profread.busy_us(iv) == pytest.approx(615.0)
    ops = profread.op_seconds(iv)
    assert list(ops)[0] == "void table_kernel<EllDocs>(...)"
    assert ops["sort_kernel"] == pytest.approx(200e-6)
    assert profread.gaps(iv) == [(20.0, 30.0), (230.0, 250.0),
                                 (350.0, 400.0), (405.0, 530.0),
                                 (730.0, 750.0)]
    idle = profread.idle_by_host(ev, iv)
    # innermost host event at each gap's middle
    assert idle["aten::copy_"] == pytest.approx(10e-6)
    assert idle["cudaMemcpyAsync"] == pytest.approx(50e-6)
    assert idle["searchbench.search"] == pytest.approx(40e-6)
    assert idle[profread.NO_HOST_OP] == pytest.approx(125e-6)
    assert profread.top(idle, 2) == [[profread.NO_HOST_OP, idle[
        profread.NO_HOST_OP]], ["cudaMemcpyAsync", idle["cudaMemcpyAsync"]]]


def test_match_ms():
    read = harness.reader("match_ms")
    assert read(records()) == pytest.approx(0.2)
    assert read(records(spans=[])) is None
    assert read(records(events=EVENTS[:3])) is None


def test_scan_roofline():
    read = harness.reader("scan_roofline")
    assert read(records()) == pytest.approx(100 * 2e-4 / 615e-6)
    assert read(records(busy_s=0.0)) is None
    assert read(records(spans=[(0, 1, 32, None)])) is None


def test_device_idle():
    read = harness.reader("device_idle")
    assert read(records()) == pytest.approx(38.5)
    assert read(records(busy_s=0.0)) is None


def test_search_ms():
    read = harness.reader("search_ms")
    assert read(records()) == pytest.approx(0.42)
    assert read(records(spans=[])) is None


def test_queue_wait_ms():
    read = harness.reader("queue_wait_ms")
    obs = Obs()
    assert read(records(registry=obs.registry)) is None
    h = obs.registry.histogram("serve_queue_wait_ms")
    for v in (3.0, 3.0, 3.0):
        h.observe(v)
    assert read(records(registry=obs.registry)) == pytest.approx(3.0)
    assert read(records(registry=None)) is None


def test_batch_size():
    read = harness.reader("batch_size")
    assert read(records(stats=BatcherStats())) is None
    assert read(records(stats=BatcherStats(n_requests=96, n_batches=3))) \
        == 32.0
