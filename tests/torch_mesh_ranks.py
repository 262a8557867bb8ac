"""The ranks of ``tests/test_torch_mesh.py``: each runs in a process of its
own (``torch.multiprocessing.spawn``), joins a gloo group through a
``FileStore`` under the test's directory (no port to collide on), imports
torch and ``repro_torch`` only, runs its job on the CPU and pickles what
it found to ``<dir>/<rank>.pkl`` for the test process to read.

Not a test module: pytest collects ``test_*.py`` only.
"""
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.paper_search import smoke
from repro_torch.core import corpus as corpus_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.corpus import Corpus
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.launch import mesh as launch_mesh
from repro_torch.serve import Query, QueryOptions
from repro_torch.storage import FlashSearchSession, FlashStore

# ranks that diverge fail the run at this timeout instead of hanging it
TIMEOUT = datetime.timedelta(seconds=120)
ENGINE_BACKENDS = ("torch", "gpu", "gpu_packed")
# the reference's multi-device test corpus: smoke(), 256 docs, seed 5
ENGINE_DOCS, ENGINE_SEED = 256, 5
ENGINE_QUERIES = {4: [3, 77, 150, 200], 3: [5, 100, 255]}
TOPK_L, TOPK_K, TOPK_PER = 3, 4, 16


def run(world, job, root, **kw):
    """Run ``job`` on ``world`` gloo ranks; every rank's result, by rank."""
    mp.spawn(_entry, args=(world, str(root), job, kw), nprocs=world,
             join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(root, f"{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, root, job, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = JOBS[job](**kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def ctx_of(shape, names=("data", "model"), dp_axes=("data",)):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    return MeshCtx(mesh, dp_axes=dp_axes, device="cpu")


def engine_corpus():
    cfg = smoke()
    return corpus_lib.synthesize(ENGINE_DOCS, cfg.vocab_size,
                                 cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                 seed=ENGINE_SEED)


def engine_queries(corpus, L):
    qs = [corpus_lib.make_query(corpus, i, smoke().max_query_nnz)
          for i in ENGINE_QUERIES[L]]
    return np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])


def padded_corpus(nan_sign):
    """Three documents on four mesh rows: row blocks 3 and 4 of the padded
    corpus are all padding. Doc 1's score is NaN for a query that meets
    its first word: +NaN (``nan_sign`` 1: a NaN count, the norm left
    finite), as the card makes it, or -NaN (``nan_sign`` -1: an infinite
    count and norm, inf / inf), as the CPU makes it."""
    cfg = smoke()
    c = corpus_lib.synthesize(3, cfg.vocab_size, cfg.avg_nnz_per_doc,
                              cfg.nnz_pad, seed=11)
    vals, norms = c.vals.copy(), c.norms.copy()
    vals[1, 0] = np.nan if nan_sign > 0 else np.inf
    if nan_sign < 0:
        norms[1] = np.inf
    return Corpus(c.doc_ids, c.ids, vals, norms)


def padded_queries(corpus):
    qs = [corpus_lib.make_query(corpus, i, smoke().max_query_nnz)
          for i in (0, 2, 0)]
    qi, qv = np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])
    qi[1, :4] = corpus.ids[1, :4]          # row 1 meets doc 1's NaN
    qv[1, :4] = 1.0
    return qi, qv


def slabs(corpus):
    """Streaming slabs of 5, 3 and 1 rows (not multiples of the rows)."""
    return [corpus.slice_rows(a, b) for a, b in ((0, 5), (5, 8), (8, 9))]


def topk_inputs():
    """[8 * TOPK_PER, L] scores over 8 row blocks of TOPK_PER, block 0
    all padding (doc id -1). Column 0 holds NaN and +inf among ties;
    column 1 one 1.0 a block, so its top-k ties across ranks; column 2
    is -inf but for two rows, so padding ties with real documents."""
    rng = np.random.default_rng(0)
    n = 8 * TOPK_PER
    scores = rng.choice(np.float32([0.25, 0.5, 0.75]), (n, TOPK_L))
    scores[rng.choice(n, 3, replace=False), 0] = [np.nan, np.nan, np.inf]
    scores[np.arange(8) * TOPK_PER + rng.integers(0, TOPK_PER, 8), 1] = 1.0
    scores[:, 2] = -np.inf
    scores[[20, 100], 2] = 0.5
    doc_ids = np.arange(n, dtype=np.int32)
    doc_ids[:TOPK_PER] = -1
    return scores, doc_ids


def _res(r):
    return r.doc_ids, r.scores


def job_eight():
    """World of 8: the reference's 4 x 2 engine, padding, gpu_fused's
    refusal, tree_topk against tree_topk_ppermute on an 8-rank axis, and
    make_ctx on a world of 8."""
    cfg = smoke()
    ctx = ctx_of((4, 2))
    out = {"shape": ctx.shape, "dp_index": ctx.dp_index,
           "model": ctx.coord("model")}
    corpus = engine_corpus()
    for backend in ENGINE_BACKENDS:
        eng = PatternSearchEngine(corpus, cfg, backend=backend, ctx=ctx)
        out["rows", backend] = eng.d_ids.shape[0]
        for L in ENGINE_QUERIES:
            out["engine", backend, L] = _res(eng.search_typed(
                Query(*engine_queries(corpus, L))))
        out["keys", backend] = eng.compile_stats["buckets"]
    for backend in ("torch", "gpu"):
        for sign in (1, -1):
            pc = padded_corpus(sign)
            eng = PatternSearchEngine(pc, cfg, backend=backend, ctx=ctx)
            out["pad", backend, sign] = _res(eng.search_typed(
                Query(*padded_queries(pc))))
        eng = PatternSearchEngine(None, cfg, backend=backend, ctx=ctx)
        out["stream", backend] = _res(eng.search_streaming(
            *engine_queries(corpus, 3), iter(slabs(corpus))))
    try:
        PatternSearchEngine(corpus, cfg, backend="gpu_fused", ctx=ctx)
    except ValueError as e:
        out["fused_error"] = str(e)
    for name, c in (("8", ctx_of((8, 1))), ("4x2", ctx)):
        n = c.shape["data"]
        scores, doc_ids = topk_inputs()
        per = scores.shape[0] // n
        r = c.coord("data")
        rows = slice(r * per, (r + 1) * per)
        v, i = topk_lib.local_topk(torch.from_numpy(scores[rows]),
                                   torch.from_numpy(doc_ids[rows]), TOPK_K)
        g = topk_lib.tree_topk(v, i, TOPK_K, c, "data")
        p = topk_lib.tree_topk_ppermute(v, i, TOPK_K, c, "data", n)
        out["topk", name] = tuple(t.numpy() for t in (*g, *p))
    try:
        launch_mesh.make_ctx(device="cpu")
    except ValueError as e:
        out["make_ctx_error"] = str(e)
    return out


def session_docs():
    """150 documents in three vocabulary bands of 50 (a narrow query's
    words live in one band, so the filter skips segments elsewhere)."""
    cfg = smoke()
    band = cfg.vocab_size // 3
    rng = np.random.default_rng(7)
    docs = []
    for i in range(150):
        lo = (i // 50) * band
        words = rng.choice(np.arange(lo, lo + band),
                           int(rng.integers(6, 13)), replace=False)
        docs.append((i, sorted((int(w), int(rng.integers(1, 30)))
                               for w in words)))
    return docs


def build_store(root):
    """Segments of 61, 40, 39, 7 and 3 documents: uneven, the largest
    padding to 62 rows on a mesh of 2."""
    docs = session_docs()
    store = FlashStore.create(str(root), vocab_size=smoke().vocab_size,
                              docs_per_segment=61)
    for lo, hi, per in ((0, 61, 61), (61, 140, 40), (140, 150, 7)):
        store.append_docs(docs[lo:hi], docs_per_segment=per)
    store.close()


def session_queries():
    """name -> (q_ids, q_vals, QueryOptions or None): self-queries of
    documents in every band with words from all over the vocabulary, a
    narrow one, and the approximate tier."""
    cfg = smoke()
    docs = dict(session_docs())
    rng = np.random.default_rng(3)

    def rows(idxs, extra):
        qi = np.full((len(idxs), cfg.max_query_nnz), -1, np.int32)
        qv = np.zeros((len(idxs), cfg.max_query_nnz), np.float32)
        for r, i in enumerate(idxs):
            pairs = dict(docs[i])
            for w in rng.choice(cfg.vocab_size, extra, replace=False):
                pairs.setdefault(int(w), 1)
            items = sorted(pairs.items())[:cfg.max_query_nnz]
            qi[r, :len(items)] = [w for w, _ in items]
            qv[r, :len(items)] = [c for _, c in items]
        return qi, qv

    broad = rows([3, 70, 145], 24)
    # approx first: a slab-cache hit would take the exact path
    return {"approx": (*rows([10, 120], 4),
                       QueryOptions(mode="approx", candidates=8)),
            "cold": (*broad, None), "warm": (*broad, None),
            "narrow": (*rows([65, 80], 0), None)}


def session_results(sess):
    """Each session query in turn: (doc_ids, scores, last_stats)."""
    import dataclasses
    out = {}
    for name, (qi, qv, opts) in session_queries().items():
        r = sess.search_typed(Query(qi, qv), opts)
        out[name] = (*_res(r), dataclasses.asdict(sess.last_stats))
    return out


def engine_requests(corpus):
    rng = np.random.default_rng(1)
    reqs = []
    for L in range(1, 6):
        idx = rng.integers(0, corpus.n_docs, L)
        qs = [corpus_lib.make_query(corpus, int(i), smoke().max_query_nnz)
              for i in idx]
        reqs.append((np.stack([q[0] for q in qs]),
                     np.stack([q[1] for q in qs])))
    return reqs


def job_four(store_root):
    """World of 4 (2 x 2): the store session on the mesh, the engine at
    L = 1..5, and make_ctx on a world of 4."""
    cfg = smoke()
    ctx = ctx_of((2, 2))
    out = {}
    for backend in ENGINE_BACKENDS:
        sess = FlashSearchSession(FlashStore.open(store_root), cfg,
                                  backend=backend, ctx=ctx)
        try:
            out["session", backend] = session_results(sess)
            out["plan", backend] = (sess._planner.rows, sess._slab_docs)
        finally:
            sess.close()
    corpus = engine_corpus()
    eng = PatternSearchEngine(corpus, cfg, backend="gpu", ctx=ctx)
    out["engine"] = [_res(eng.search_typed(Query(*q)))
                     for q in engine_requests(corpus)]
    out["slab_fmt"] = (eng.slab_fmt, PatternSearchEngine(
        None, cfg, backend="gpu_packed", ctx=ctx).slab_fmt)
    try:
        launch_mesh.make_ctx(device="cpu")
    except ValueError as e:
        out["make_ctx_error"] = str(e)
    return out


JOBS = {"eight": job_eight, "four": job_four}
