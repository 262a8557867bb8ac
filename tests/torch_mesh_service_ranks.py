"""The ranks of ``tests/test_torch_mesh_service.py``: the serving tier and
the write path on a mesh. Each rank runs in a process of its own
(``torch.multiprocessing.spawn``), joins a gloo group through a
``FileStore`` under the test's directory, imports torch and
``repro_torch`` only, and pickles what it found to ``<dir>/<rank>.pkl``.
Rank 0 leads every service; the other ranks check what a follower may
not do, then ``follow()`` each service until rank 0 closes it.

Not a test module: pytest collects ``test_*.py`` only.
"""
import dataclasses
import datetime
import os
import pickle
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.paper_search import smoke
from repro_torch.core.corpus import Corpus
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.distributed import lockstep
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.serve import (AdmissionController, DeadlineExceeded,
                               OverloadError, Query, QueryOptions,
                               SearchService)
from repro_torch.serve.search_service import follow
from repro_torch.storage import FlashSearchSession, FlashStore
from repro_torch.storage.slabcache import SlabCache

# ranks that diverge fail the run at this timeout instead of hanging it
TIMEOUT_S = 120
# the small world's own timeout: its planted divergence fails in seconds
SHORT_TIMEOUT_S = 5
BACKENDS = ("torch", "gpu", "gpu_packed")
CLIENTS, MAX_BATCH = 4, 4
SEAL_DOCS = 8
# the write path's op sequence: appends of new_docs[a:b], then a search
LIVE_APPENDS = ((0, 20), (20, 30))
COMPACT_APPENDS = 64
# queries whose batches raise once their records went out: (value,
# the rank that raises or None for every rank, before or after scoring)
POISONS = ((1234.0, None, "before"), (2345.0, 0, "after"),
           (3456.0, 3, "after"))
# the approximate tier: the ranks that keep a slab cache, by case; an
# exact session warms the caches with APPROX_QUERIES[0], then an auto
# session (approx past one doc, a pool of APPROX_CANDIDATES) serves both
APPROX_CACHES = {"leader_warm": range(4), "leader_cold": range(1, 8)}
APPROX_QUERIES = (5, 6)
APPROX_CANDIDATES = 1


def run(world, job, root, timeout_s=TIMEOUT_S, **kw):
    """Run ``job`` on ``world`` gloo ranks; every rank's result, by rank."""
    os.makedirs(root, exist_ok=True)
    mp.spawn(_entry, args=(world, str(root), job, timeout_s, kw),
             nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(root, f"{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, root, job, timeout_s, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = JOBS[job](**kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def ctx_of(shape):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    return MeshCtx(mesh, device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _row(r):
    return np.asarray(r.doc_ids), np.asarray(r.scores)


def serve(submit, queries, options=None):
    """Every query (q_ids, q_vals) through ``submit`` from CLIENTS
    threads; the rows in query order."""
    rows = [None] * len(queries)
    errors = []

    def client(t):
        try:
            for i in range(t, len(queries), CLIENTS):
                rows[i] = _row(submit(Query(*queries[i]),
                                      options=options).result(timeout=120))
        except Exception as e:      # reported to the test below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"clients failed: {errors}")
    return rows


def _stats(st):
    return dataclasses.asdict(st)


def poison_query(value):
    return np.array([3], np.int32), np.array([value], np.float32)


def poisoned(search_view):
    """``search_view`` that raises on a batch holding a POISONS query, on
    that query's rank, before or after scoring it."""
    def view(view, snap, q_ids, q_vals, *a, **kw):
        for value, rank, when in POISONS:
            hit = (np.asarray(q_vals) == value).any() and rank in (
                None, dist.get_rank())
            if hit and when == "before":
                raise ValueError("a poisoned batch")
            if hit:
                search_view(view, snap, q_ids, q_vals, *a, **kw)
                raise ValueError("a poisoned batch")
        return search_view(view, snap, q_ids, q_vals, *a, **kw)
    return view


def _refused(call):
    try:
        call()
    except RuntimeError as e:
        return str(e)
    return None


def job_serve(roots, queries, corpus, new_docs, live_queries):
    """World of 8 (4 x 2): every served surface, one service after the
    other, each followed by ranks 1-7."""
    cfg = smoke()
    ctx = ctx_of((4, 2))
    leader = lockstep.role(ctx) == lockstep.LEADER
    out = {"role": lockstep.role(ctx)}

    def session(root, backend="gpu", **kw):
        return FlashSearchSession(FlashStore.open(root), cfg,
                                  backend=backend, ctx=ctx, **kw)

    # 1. read-only, each backend
    for backend in BACKENDS:
        sess = session(roots["ro"], backend)
        try:
            if leader:
                svc = sess.service(max_batch=MAX_BATCH)
                out["ro", backend] = serve(sess.submit, queries)
                out["batches", backend] = svc.stats.n_batches
                out["lockstep", backend] = _stats(svc.lockstep_stats)
            else:
                out["lockstep", backend] = _stats(sess.follow())
        finally:
            sess.close()

    # 2. service options: a past deadline, a quota shed, k truncation;
    # then a batch that raises on every rank, and one after it
    sess = session(roots["ro"])
    sess._search_view = poisoned(sess._search_view)
    try:
        if leader:
            clock = FakeClock()
            svc = SearchService(sess, max_batch=MAX_BATCH,
                                admission=AdmissionController(
                                    tenant_qps=1.0, tenant_burst=1.0,
                                    clock=clock))
            fut = svc.submit(Query(*queries[0]), options=QueryOptions(
                deadline_ms=0.0, tenant="late"))
            try:
                fut.result(timeout=60)
            except DeadlineExceeded as e:
                out["deadline"] = e.where
            r = svc.submit(Query(*queries[1]), options=QueryOptions(
                tenant="a", k=2)).result(timeout=60)
            out["k2"] = _row(r)
            try:
                svc.submit(Query(*queries[2]), options=QueryOptions(
                    tenant="a"))
            except OverloadError as e:
                out["shed"] = e.reason
            clock.t += 1.0
            out["after_shed"] = _row(svc.submit(
                Query(*queries[2]), options=QueryOptions(
                    tenant="a")).result(timeout=60))
            out["poisoned"] = []
            for value, _, _ in POISONS:
                try:
                    svc.submit(Query(*poison_query(value)),
                               options=QueryOptions(tenant=str(value))
                               ).result(timeout=60)
                except Exception as e:     # what the client sees
                    out["poisoned"].append((type(e).__name__, str(e)))
            out["after_poison"] = _row(svc.submit(
                Query(*queries[4]), options=QueryOptions(
                    tenant="c")).result(timeout=60))
            out["opts"] = _stats(svc.lockstep_stats)
            svc.close()
        else:
            out["opts"] = _stats(follow(sess))
    finally:
        sess.close()

    # 3. the resident engine behind a SearchService
    eng = PatternSearchEngine(Corpus(*corpus), cfg, backend="gpu", ctx=ctx)
    if leader:
        with SearchService(eng, max_batch=MAX_BATCH) as svc:
            out["engine"] = serve(svc.submit, queries)
            out["engine_batches"] = svc.stats.n_batches
    else:
        out["engine_batches"] = follow(eng).batches
        out["engine_service"] = _refused(lambda: SearchService(eng))

    # 4. the write path: append, search, flush, append, search, compact,
    # search
    sess = session(roots["live"])
    try:
        if leader:
            sess.enable_ingest(seal_docs=SEAL_DOCS, auto_compact=False)
            sess.service(max_batch=MAX_BATCH)
            for step, (a, b) in enumerate(LIVE_APPENDS):
                for d, p in new_docs[a:b]:
                    sess.append(d, p)
                out["live", step] = serve(sess.submit, live_queries)
                if step == 0:
                    sess.flush_ingest()
            sess.ingest.compact_once()
            out["live", 2] = serve(sess.submit, live_queries)
            out["ingest_stats"] = _stats(sess.ingest.stats)
            out["live_batches"] = sess.service().lockstep_stats.batches
        else:
            for name, call in (
                    ("enable_ingest", sess.enable_ingest),
                    ("append", lambda: sess.append(*new_docs[0])),
                    ("flush_ingest", sess.flush_ingest),
                    ("service", sess.service),
                    ("submit", lambda: sess.submit(Query(*queries[0])))):
                out["refused", name] = _refused(call)
            out["live_batches"] = sess.follow().batches
            out["follower_ingest"] = sess.ingest
    finally:
        sess.close()

    # 5. the compactor folds under a live service
    sess = session(roots["compact"])
    try:
        if leader:
            pipe = sess.enable_ingest(seal_docs=SEAL_DOCS, auto_compact=True,
                                      compact_poll_s=0.01)
            sess.service(max_batch=MAX_BATCH)
            done = threading.Event()

            def writer():
                for d, p in new_docs[:COMPACT_APPENDS]:
                    sess.append(d, p)
                done.set()

            # clients serve from before the first append until the
            # writer is done and the compactor has folded twice
            w = threading.Thread(target=writer)
            for rnd in range(400):
                serve(sess.submit, queries[:8])
                if rnd == 0:
                    w.start()
                if done.is_set() and pipe.stats.compactions >= 2:
                    break
            w.join(timeout=60)
            sess.flush_ingest()
            out["compact_last"] = serve(sess.submit, live_queries)
            out["compact_stats"] = _stats(pipe.stats)
            out["compact_lockstep"] = _stats(
                sess.service().lockstep_stats)
        else:
            out["compact_lockstep"] = _stats(sess.follow())
    finally:
        sess.close()

    # 6. the memo: the same query twice; ranks 4-7 keep none, so only
    # the leader's verdict keeps them from scoring the second time alone
    sess = session(roots["ro"], memo_entries=8 if dist.get_rank() < 4 else 0)
    try:
        if leader:
            svc = sess.service(max_batch=MAX_BATCH)
            out["memo_rows"] = [_row(svc.submit(Query(*queries[3])).result(
                timeout=60)) for _ in range(2)]
            svc.close()
        else:
            sess.follow()
        memo = sess.memo_stats
        out["memo"] = (memo and (memo.hits, memo.misses),
                       sess.last_stats.memo_hits)
    finally:
        sess.close()

    # 7. the approximate tier scores a cached segment's whole slab: the
    # leader's cache verdict binds every rank, whatever its cache holds
    for case, keep in APPROX_CACHES.items():
        cache = SlabCache() if dist.get_rank() in keep else None
        store = FlashStore.open(roots["ro"])    # one cache token
        sessions = [FlashSearchSession(store, cfg, backend="gpu", ctx=ctx,
                                       slab_cache=cache, cache_bytes=0,
                                       **kw)
                    for kw in ({}, dict(mode="auto", approx_min_docs=1,
                                        candidates=APPROX_CANDIDATES))]
        try:
            for i, sess in enumerate(sessions):
                if not leader:
                    sess.follow()
                    continue
                svc = sess.service(max_batch=MAX_BATCH)
                qs = APPROX_QUERIES[:1] if i == 0 else APPROX_QUERIES
                rows = [_row(svc.submit(Query(*queries[q])).result(
                    timeout=60)) for q in qs]
                svc.close()
                out["approx", case] = rows
        finally:
            for sess in sessions:
                sess.close()
    return out


def _raise_before_scoring(record):
    raise ValueError("a follower that fails before it scores")


def job_short(store_root, queries):
    """World of 2 (2 x 1) with a SHORT_TIMEOUT_S group timeout: the
    leader idles past the timeout (the follower waits for its records on
    the lockstep's own group), then the follower plants a divergence: it
    raises before it scores, so the leader's batch waits in the engine's
    reduction, both ranks raise within the timeout, and the lockstep
    stays broken."""
    cfg = smoke()
    ctx = ctx_of((2, 1))
    sess = FlashSearchSession(FlashStore.open(store_root), cfg,
                              backend="torch", ctx=ctx)
    out = {}
    try:
        if lockstep.role(ctx) == lockstep.LEADER:
            svc = sess.service(max_batch=MAX_BATCH)
            time.sleep(1.5 * SHORT_TIMEOUT_S)
            out["after_idle"] = _row(svc.submit(Query(*queries[0])).result(
                timeout=60))
            svc.close()
            svc = SearchService(sess, max_batch=MAX_BATCH)
            for name in ("diverged", "after", "later"):
                try:
                    svc.submit(Query(*queries[1])).result(timeout=60)
                    out[name] = None
                except Exception as e:     # what the client sees
                    out[name] = (type(e).__name__, str(e))
            out["diverged_stats"] = _stats(svc.lockstep_stats)
            svc.close()
        else:
            out["idle"] = _stats(sess.follow())
            try:
                lockstep.follow(ctx, _raise_before_scoring)
                out["diverged"] = None
            except Exception as e:         # the follower's own failure
                out["diverged"] = (type(e).__name__, str(e))
    finally:
        sess.close()
    return out


JOBS = {"serve": job_serve, "short": job_short}
