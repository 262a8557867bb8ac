"""Live ingestion on the PyTorch/CUDA port: documents appended while a
reader loops, then online compaction shrinking the segment count under
that same reader (DESIGN.md §6).

A writer thread appends 3,000 documents one at a time through the
WAL -> memtable -> delta-segment pipeline while the main thread keeps
searching on the card. Every search sees an atomic snapshot — the
visible doc count only ever grows while the delta segments pile up —
then one compaction folds the pile into full segments, shrinking the
segment count without perturbing the reader. The finale proves the
differential contract: the live store's top-k is bit-identical to a
from-scratch store built over the same documents. The same run as
``examples/live_ingest.py``, on the port.

    PYTHONPATH=src python examples/port_live_ingest.py [--device cpu]

``--device`` defaults to the CUDA card (and fails without one); on the
CPU the kernels' plain versions score.
"""
import argparse
import os
import shutil
import tempfile
import threading
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
    cfg = SearchConfig(name="live-demo", vocab_size=20_000,
                       avg_nnz_per_doc=40, nnz_pad=64, top_k=5)
    n_base, n_live = 2_000, 3_000
    rng = np.random.default_rng(0)

    def make_doc(i):
        words = rng.choice(cfg.vocab_size, cfg.avg_nnz_per_doc,
                           replace=False)
        return (i, sorted((int(w), int(rng.integers(1, 30)))
                          for w in words))

    docs = [make_doc(i) for i in range(n_base + n_live)]

    tmp = tempfile.mkdtemp()
    store = FlashStore.create(os.path.join(tmp, "live"),
                              vocab_size=cfg.vocab_size,
                              docs_per_segment=500)
    store.append_docs(docs[:n_base])
    sess = FlashSearchSession(store, cfg, args.device, args.backend)
    # auto_compact=False so the delta segments pile up visibly and the
    # fold below has something to show; production leaves the background
    # compactor on and never sees the pile
    sess.enable_ingest(seal_docs=200, fold_min_segments=4,
                       auto_compact=False)
    print(f"base store: {store.n_segments} segments, {store.n_docs} docs "
          f"on {sess.engine.device} ({args.backend}); writer will append "
          f"{n_live} more while we search")

    target = docs[n_base + n_live - 1]       # the very last live doc
    qi = np.full((1, cfg.max_query_nnz), -1, np.int32)
    qv = np.zeros((1, cfg.max_query_nnz), np.float32)
    for j, (w, c) in enumerate(target[1]):
        qi[0, j] = w
        qv[0, j] = c
    query = Query(qi, qv)
    sess.search(query)                       # build the kernels first

    done = threading.Event()

    def writer():
        for d, p in docs[n_base:]:
            sess.append(d, p)
            time.sleep(0)                    # yield to the reader
        done.set()

    threading.Thread(target=writer, daemon=True).start()

    # -- reader loop: snapshots only ever grow -------------------------
    seen = 0
    while not done.is_set():
        sess.search(query)
        st = sess.last_stats
        assert st.docs_scored >= seen, "snapshot went backwards!"
        seen = st.docs_scored
        print(f"  search saw {st.docs_scored:5d} docs "
              f"({st.segments_total} segments, "
              f"{st.memtable_docs} still in memtable)")
        time.sleep(0.15)

    res = sess.search(query)
    print(f"\nwriter done: top hit doc {res.doc_ids[0, 0]} "
          f"(expected {target[0]}) from "
          f"{sess.last_stats.docs_scored} docs")
    assert res.doc_ids[0, 0] == target[0]

    # -- compaction shrinks the segment count under the reader ---------
    before = store.n_segments
    sess.flush_ingest()                      # seal the tail...
    while sess.ingest.compact_once():        # ...and fold to full segments
        pass
    print(f"compaction: {before} segments -> {store.n_segments} "
          f"(docs unchanged: {store.n_docs})")
    assert store.n_segments < before

    # -- differential finale: bit-identical to a from-scratch store ----
    ref_store = FlashStore.create(os.path.join(tmp, "ref"),
                                  vocab_size=cfg.vocab_size,
                                  docs_per_segment=500)
    ref_store.append_docs(docs)
    with FlashSearchSession(ref_store, cfg, args.device,
                            args.backend) as ref:
        want = ref.search(query)
    got = sess.search(query)
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(got.scores.view(np.uint32),
                                  want.scores.view(np.uint32))
    print("OK: live store top-k == from-scratch store top-k, bit for bit")

    sess.close()
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
