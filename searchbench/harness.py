"""One run of one cell: set-up, the measured window, the check, the line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<name>.json``: the corpus, its layout on the card, the
backend and the service) and a traffic mix (``traffic/<name>.json``:
clients and the query pool). Per-layer metrics are readers of their own
(``metrics/<name>.py``: ``read(records)`` -> a number or None). The
harness finds all three by name, so a cell, a configuration or a metric
is added as files and manifest entries alone.

Set-up: build the search kernels into the port's ``build/kernels/``
(``repro_torch.kernels._build``), make the corpus on the card from the
seed (``corpusgen``), hand it to a ``PatternSearchEngine`` as a slab
already on the card (``DeviceSlab`` for ELL, ``PackedSlab`` for Fig. 8
tiles), and warm the L buckets that the traffic reaches. The window:
client threads call ``SearchService.submit`` for ``seconds``; the
service's searcher is ``SlabSearcher``, which scores each coalesced
batch with ``engine.search_streaming(q_ids, q_vals, [slab])``. After the
window: the memory peak, then the program's state is freed and every
answer is held to the plain reference (``checks``, ``reference``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from searchbench import checks, corpusgen, load, profread, reference
from searchbench import roofline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNELS = ("sparse_match", "fused")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell(name: str, manifest: Optional[dict] = None):
    """(workload entry, configuration, traffic) of cell ``name``."""
    manifest = manifest or read_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = read_json(HERE / "configs" / f"{wl['config']}.json")
    traffic = read_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, traffic


def metrics_of(manifest: dict, wl_name: str, section: str) -> List[dict]:
    return [m for m in manifest[section]
            if wl_name in m.get("workloads", [wl_name])]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"searchbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class SlabSearcher:
    """The service's searcher: one coalesced batch against the slab on
    the card through the engine's public streaming surface. Its span
    (``spans``: host clock before and after, and the batch's ids) is the
    harness's own, labelled ``searchbench.search`` in a trace."""

    def __init__(self, engine, slab):
        self.engine, self.slab = engine, slab
        self.obs = engine.obs
        self.spans: Optional[list] = None

    def search(self, q_ids, q_vals):
        t0 = time.perf_counter()
        with torch.profiler.record_function("searchbench.search"):
            res = self.engine.search_streaming(q_ids, q_vals, [self.slab])
        if self.spans is not None:
            self.spans.append((t0, time.perf_counter(), q_ids))
        return res


def port_searcher(cfg: dict, built, device) -> SlabSearcher:
    from repro_torch.configs.paper_search import SearchConfig
    from repro_torch.core.engine import DeviceSlab, PatternSearchEngine
    from repro_torch.kernels.fused import PackedSlab
    from repro_torch.obs import Obs
    scfg = SearchConfig(
        name=cfg["name"], vocab_size=cfg["vocab_size"],
        avg_nnz_per_doc=cfg["avg_nnz_per_doc"],
        max_query_nnz=cfg["max_query_nnz"], nnz_pad=cfg["nnz_pad"],
        top_k=cfg["top_k"], block_docs=cfg["block_docs"],
        block_query=cfg["block_query"])
    engine = PatternSearchEngine(None, scfg, device=device,
                                 backend=cfg["backend"], obs=Obs())
    s = built.slab
    slab = (DeviceSlab(s["ids"], s["vals"], s["norms"], s["doc_ids"])
            if cfg["layout"] == "ell" else PackedSlab(s["tiles"]))
    return SlabSearcher(engine, slab)


def buckets(cfg: dict, traffic: dict) -> List[int]:
    """The L buckets the traffic's batches can take."""
    top = min(traffic["clients"], cfg["service"]["max_batch"])
    return sorted({roofline.bucket(L) for L in range(1, top + 1)})


def stack(queries, rows) -> tuple:
    width = max(queries[r][0].size for r in rows)
    qi = np.full((len(rows), width), -1, np.int32)
    qv = np.zeros((len(rows), width), np.float32)
    for l, r in enumerate(rows):
        qi[l, :queries[r][0].size] = queries[r][0]
        qv[l, :queries[r][1].size] = queries[r][1]
    return qi, qv


class Records(NamedTuple):
    """What a per-layer metric reads of a traced run."""
    config: dict
    intervals: list           # device (start us, end us, name)
    busy_s: float
    window_s: float
    spans: list               # (t0, t1, L, least seconds or None)
    registry: object          # the engine's and service's obs registry
    stats: object             # the service's BatcherStats


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def run(wl_name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_process: Optional[float] = None,
        overrides: Optional[dict] = None, make_searcher=port_searcher,
        manifest: Optional[dict] = None, log=print) -> dict:
    """One run; returns the result line's object. ``overrides`` replaces
    configuration keys (the tests' small corpora); ``make_searcher``
    puts another searcher in the program's place (the control)."""
    t_process = time.perf_counter() if t_process is None else t_process
    manifest = manifest or read_json(ROOT / "BENCHMARK.json")
    wl, cfg, traffic = cell(wl_name, manifest)
    cfg = {**cfg, **(overrides or {})}
    drive = load.loop(traffic)
    dev = torch.device(device)
    marks = {}
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        marks["import"] = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=dev)
        marks["cuda"] = time.perf_counter()
        built_now = _build.build(KERNELS)
        marks["build"] = time.perf_counter()
        log(f"kernels built now: {sorted(built_now) or 'none'}")
    built = corpusgen.build(cfg, traffic, seed, dev)
    sync(dev)
    marks["corpus"] = time.perf_counter()
    searcher = make_searcher(cfg, built, dev)
    built = built._replace(slab=None)
    queries = built.queries
    first = load.order(len(queries))
    for L in buckets(cfg, traffic):
        searcher.search(*stack(queries, first[:L]))
    sync(dev)
    marks["warm"] = time.perf_counter()

    from repro_torch.serve import Query, SearchService
    svc = SearchService(searcher, max_batch=cfg["service"]["max_batch"],
                        max_delay_ms=cfg["service"]["max_delay_ms"])
    pool = [Query(qi, qv) for qi, qv in queries]
    spans = []
    if hasattr(searcher, "spans"):
        searcher.spans = spans
    gc.collect()
    gc.freeze()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # every thread's ops: the service's batcher launches the work
        prof = torch.profiler.profile(
            activities=acts,
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True))
        prof.start()
    t_prof = time.perf_counter()
    setup_s = t_prof - t_process
    res = drive(lambda q: svc.submit(pool[q]), len(pool), traffic["clients"],
                seconds)
    sync(dev)
    t_stop = time.perf_counter()
    if prof is not None:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    stats = svc.stats
    registry = getattr(getattr(searcher, "obs", None), "registry", None)
    svc.close()
    gc.unfreeze()
    for line in describe(setup_s, t_process, marks, res, spans):
        log(line)

    lat = np.asarray([(a[2] - a[1]) * 1e3 for a in res.answers])
    e2e = {"qps": scored(spans, res) / seconds,
           "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
           "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
           "setup_s": setup_s}

    per_layer, breakdown, device_info = {}, None, {}
    if trace:
        per_layer, breakdown, device_info = read_trace(
            prof, cfg, built, spans, t_stop - t_prof, registry, stats, dev,
            manifest, wl_name)
        prof = None

    # the program's state goes before the reference runs
    searcher = svc = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check(cfg, traffic, seed, queries, res, dev)
    log(f"reference and check {time.perf_counter() - t_ref:.3f} s")
    correct = checks.verdict(numbers) and res.stragglers == 0

    section = "per_layer" if trace else "end_to_end"
    out = {}
    for m in metrics_of(manifest, wl_name, section):
        v = (per_layer if trace else e2e).get(m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct), "attempted": res.attempted,
        "failed": res.attempted - len(res.answers), "metrics": out,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    for err in sorted(set(res.errors))[:5]:
        log(f"query error: {err}")
    result["checks"] = checks.report(numbers)
    return result


def describe(setup_s, t_process, marks, res, spans) -> List[str]:
    """Where set-up went and how the window's batches came out."""
    t, parts = t_process, []
    for name in ("import", "cuda", "build", "corpus", "warm"):
        if name in marks:
            parts.append(f"{name} {marks[name] - t:.3f}")
            t = marks[name]
    lines = [f"set-up {setup_s:.3f} s: {', '.join(parts)}; window "
             f"{res.t_end - res.t_start:.3f} s, {res.attempted} queries, "
             f"{len(spans)} batches, {res.stragglers} clients late"]
    if spans:
        sizes = np.bincount([q.shape[0] for _, _, q in spans])
        dur = np.asarray([t1 - t0 for t0, t1, _ in spans]) * 1e3
        by = {int(k): int(v) for k, v in enumerate(sizes) if v}
        lines.append(f"batches by size {by}; search ms min {dur.min():.3f} "
                     f"median {np.median(dur):.3f} max {dur.max():.3f}")
    return lines


def scored(spans, res) -> float:
    """Queries the service scored in the window. A batch is a few hundred
    ms of device work, so the one in flight when the window closes counts
    by the share of its span that lies inside the window: the count then
    moves with the rate, not in steps of a whole batch. Without spans (a
    searcher of another kind), the answers that came back in the window."""
    if not spans:
        return float(sum(a[2] <= res.t_end for a in res.answers))
    return sum(q.shape[0] * min(1.0, max(0.0, (res.t_end - t0) / (t1 - t0)))
               for t0, t1, q in spans)


def check(cfg: dict, traffic: dict, seed: int, queries, res, dev) -> dict:
    """Every answer of the window to a sample of the pool's queries, drawn
    from the seed, against the reference over the whole corpus, made
    again from the seed a chunk at a time. Every query submitted counts
    for ``lost``."""
    rng = np.random.default_rng(corpusgen.stream_seed(seed, 5))
    sample = rng.choice(len(queries), min(len(queries), traffic["checked"]),
                        replace=False)
    pos = {int(q): i for i, q in enumerate(sample)}
    answers = [(pos[a[0]],) + tuple(a[1:]) for a in res.answers
               if a[0] in pos]
    top = reference.TopK([queries[q] for q in sample], cfg["vocab_size"],
                         cfg["top_k"], reference.served_pairs(answers), dev)
    for ch in corpusgen.chunks(cfg, seed, dev):
        top.add(ch.d0, ch.ids, ch.vals)
    return checks.compare(answers, res.attempted - len(res.answers),
                          top.top_scores(), top.pair_scores(), cfg["n_docs"])


def read_trace(prof, cfg, built, spans, window_s, registry, stats, dev,
               manifest, wl_name):
    fd, path = tempfile.mkstemp(prefix="searchbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = profread.load(path)
    finally:
        os.unlink(path)
    intervals = profread.device_intervals(events)
    busy_s = profread.busy_us(intervals) / 1e6
    pk = (roofline.peaks(torch.cuda.get_device_name(dev))
          if dev.type == "cuda" else None)
    nbytes = roofline.corpus_bytes(cfg["n_docs"], built.n_pairs)
    rows = []
    for t0, t1, q_ids in spans:
        b, f = roofline.batch_work(q_ids, built.df, cfg["top_k"], nbytes)
        rows.append((t0, t1, q_ids.shape[0],
                     roofline.least_seconds(b, f, pk) if pk else None))
    rec = Records(cfg, intervals, busy_s, window_s, rows, registry, stats)
    per_layer = {}
    for m in metrics_of(manifest, wl_name, "per_layer"):
        per_layer[m["name"]] = reader(m["name"])(rec)
    breakdown = {"device_ops": profread.top(profread.op_seconds(intervals)),
                 "idle_gaps": profread.top(
                     profread.idle_by_host(events, intervals))}
    return per_layer, breakdown, {"busy_s": busy_s, "window_s": window_s}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args, t_process: float) -> int:
    manifest = read_json(ROOT / "BENCHMARK.json")
    wl, _, _ = cell(args.workload, manifest)
    if not torch.cuda.is_available():
        print("searchbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"searchbench: {wl['chips']} cards wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    err = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 device="cuda", t_process=t_process, manifest=manifest,
                 log=err)
    bad = forbidden_modules()
    if bad:
        err(f"searchbench: forbidden modules loaded: {bad}")
        return 3
    err(f"card: {power_limit()}")
    for name, c in result["checks"].items():
        err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
