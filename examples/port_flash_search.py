"""Flash-tier search on the PyTorch/CUDA port: a store bigger than one
slab, searched end to end through filter pruning, the background
prefetcher and the slab cache on the card.

Builds a FlashStore of 40k documents across 20 segments (clustered by
topic vocabulary band), then runs (1) a broad query that streams every
surviving segment through the prefetcher, (2) a narrow single-topic
query that the per-segment vocabulary filter prunes to one segment, and
(3) the broad query again, now warm: every segment comes from the slab
cache on the card, bit-identical to the cold pass. The same store as
``examples/flash_search.py`` builds, searched by the port.

    PYTHONPATH=src python examples/port_flash_search.py [--device cpu]

``--device`` defaults to the CUDA card (and fails without one); on the
CPU the kernels' plain versions score.
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--backend", default="gpu",
                    choices=["gpu", "gpu_packed", "gpu_fused", "torch"])
    args = ap.parse_args(argv)
    cfg = SearchConfig(name="flash-demo", vocab_size=50_000,
                       avg_nnz_per_doc=40, nnz_pad=64, top_k=5)
    n_docs, n_topics, per_segment = 40_000, 20, 2_000
    band = cfg.vocab_size // n_topics

    rng = np.random.default_rng(0)
    print(f"encoding {n_docs} documents into a segment store "
          f"({n_docs // per_segment} segments, Fig. 8 stream format)...")
    docs = []
    for i in range(n_docs):
        topic = (i * n_topics) // n_docs
        words = rng.choice(np.arange(topic * band, (topic + 1) * band),
                           cfg.avg_nnz_per_doc, replace=False)
        docs.append((i, sorted((int(w), int(rng.integers(1, 30)))
                               for w in words)))

    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "store")
    store = FlashStore.create(root, vocab_size=cfg.vocab_size,
                              docs_per_segment=per_segment)
    store.append_docs(docs)
    mb = sum(seg.nbytes for seg in store.segments()) / 1e6
    print(f"store: {store.n_segments} segments, {store.n_docs} docs, "
          f"{mb:.1f} MB on disk")
    sess = FlashSearchSession(store, cfg, device=args.device,
                              backend=args.backend)
    print(f"session: backend {args.backend} on {sess.engine.device}")

    # -- broad query: words from several topics -> most segments score --
    target = docs[17]
    qi = np.full((1, cfg.max_query_nnz), -1, np.int32)
    qv = np.zeros((1, cfg.max_query_nnz), np.float32)
    for j, (w, c) in enumerate(target[1]):
        qi[0, j] = w
        qv[0, j] = c
    extra = rng.choice(cfg.vocab_size, 64, replace=False)
    qi[0, len(target[1]):len(target[1]) + 64] = np.sort(extra).astype(np.int32)
    qv[0, len(target[1]):len(target[1]) + 64] = 1
    t0 = time.perf_counter()
    res = sess.search(Query(qi, qv))
    cold_ms = (time.perf_counter() - t0) * 1e3
    st = sess.last_stats
    print(f"\nbroad query: scored {st.segments_scored}/{st.segments_total} "
          f"segments ({st.docs_scored} docs), skip rate {st.skip_rate:.2f}, "
          f"{cold_ms:.1f} ms cold")
    for rank, (d, s) in enumerate(zip(res.doc_ids[0], res.scores[0])):
        print(f"  #{rank + 1}: doc {d}  cosine {s:.4f}")
    assert res.doc_ids[0, 0] == target[0]

    # -- narrow query: one topic's words -> the filter prunes the rest --
    qi2 = np.full((1, cfg.max_query_nnz), -1, np.int32)
    qv2 = np.zeros((1, cfg.max_query_nnz), np.float32)
    for j, (w, c) in enumerate(target[1]):
        qi2[0, j] = w
        qv2[0, j] = c
    res2 = sess.search(Query(qi2, qv2))
    st = sess.last_stats
    print(f"\nnarrow query: scored {st.segments_scored}/{st.segments_total} "
          f"segments ({st.docs_scored} docs), skip rate {st.skip_rate:.2f}")
    print(f"  top hit: doc {res2.doc_ids[0, 0]} "
          f"cosine {res2.scores[0, 0]:.4f}")
    assert res2.doc_ids[0, 0] == target[0]
    assert st.segments_skipped == st.segments_total - 1
    print(f"\nOK: identical top hit, {st.segments_skipped} segments never "
          "left storage")

    # -- broad query again, warm: slabs come from the cache on the card -
    t0 = time.perf_counter()
    res3 = sess.search(Query(qi, qv))
    warm_ms = (time.perf_counter() - t0) * 1e3
    st = sess.last_stats
    print(f"\nwarm broad query: {st.cache_hits}/{st.segments_scored} "
          f"slabs from cache (hit rate {st.cache_hit_rate:.2f}) "
          f"in {warm_ms:.1f} ms")
    assert st.cache_hits == st.segments_scored
    np.testing.assert_array_equal(res3.doc_ids, res.doc_ids)
    np.testing.assert_array_equal(res3.scores.view(np.uint32),
                                  res.scores.view(np.uint32))
    print("OK: warm result bit-identical to cold")

    sess.close()
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
