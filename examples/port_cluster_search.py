"""Cluster-tier search on the PyTorch/CUDA port: one corpus partitioned
over 4 shard FlashStores with 2 replicas each, served scatter/gather
behind one session (DESIGN.md §5).

Builds a topic-banded corpus, splits it with the range policy (bands
stay contiguous, so each shard's segment vocab filters stay clustered),
then runs (1) a narrow query that only one shard scores — every other
shard prunes all of its segments in storage — and (2) the same query
after killing the owning shard's primary replica, which fails over to
the second replica with the identical result. The same cluster as
``examples/cluster_search.py`` builds, searched by the port.

    PYTHONPATH=src python examples/port_cluster_search.py [--device cpu]

``--device`` defaults to the CUDA card (and fails without one); on the
CPU the kernels' plain versions score.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.cluster import FlashClusterSession, build_sharded_store
from repro_torch.configs.paper_search import SearchConfig
from repro_torch.serve import Query


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--backend", default="gpu",
                    choices=["gpu", "gpu_packed", "gpu_fused", "torch"])
    args = ap.parse_args(argv)
    cfg = SearchConfig(name="cluster-demo", vocab_size=40_000,
                       avg_nnz_per_doc=32, nnz_pad=64, top_k=5)
    n_docs, n_topics = 8_000, 16
    band = cfg.vocab_size // n_topics

    rng = np.random.default_rng(0)
    docs = []
    for i in range(n_docs):
        topic = (i * n_topics) // n_docs
        words = rng.choice(np.arange(topic * band, (topic + 1) * band),
                           cfg.avg_nnz_per_doc, replace=False)
        docs.append((i, sorted((int(w), int(rng.integers(1, 30)))
                               for w in words)))

    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "cluster")
    print(f"partitioning {n_docs} docs into 4 shards x 2 replicas "
          f"(range policy, topic-banded)...")
    cluster = build_sharded_store(root, docs, n_shards=4, replicas=2,
                                  policy="range",
                                  vocab_size=cfg.vocab_size,
                                  docs_per_segment=500)
    for s, st in enumerate(cluster.stats()):
        print(f"  shard {s}: {st.n_docs} docs / {st.n_segments} segments / "
              f"{st.n_bytes / 1e6:.1f} MB ({st.filter_kind} filters)")

    sess = FlashClusterSession(cluster, cfg, device=args.device,
                               backend=args.backend)
    target = docs[4321]
    qi = np.full((1, cfg.max_query_nnz), -1, np.int32)
    qv = np.zeros((1, cfg.max_query_nnz), np.float32)
    for j, (w, c) in enumerate(target[1]):
        qi[0, j] = w
        qv[0, j] = c

    res = sess.search_typed(Query(qi, qv))
    st = sess.last_stats
    print(f"\nnarrow query (doc {target[0]}'s topic) on "
          f"{sess.router.device} ({args.backend}): scored "
          f"{st.segments_scored}/{st.segments_total} segments across "
          f"{sess.store.n_shards} shards, aggregate skip rate "
          f"{st.skip_rate:.2f}")
    for rank, (d, s) in enumerate(zip(res.doc_ids[0], res.scores[0])):
        print(f"  #{rank + 1}: doc {d}  cosine {s:.4f}")
    assert res.doc_ids[0, 0] == target[0]
    assert st.segments_scored < st.segments_total

    # -- kill the owning shard's primary replica mid-run ----------------
    owner = int(cluster.partitioner.shard_of([target[0]])[0])
    victim = sess.router._session(owner, 0)
    shutil.rmtree(victim.store.root)             # the slice "dies"
    victim.store.manifest["segments"] = [        # poison the cached handle
        {**e, "name": "gone-" + e["name"]}
        for e in victim.store.manifest["segments"]]
    print(f"\nkilled shard {owner} replica 0; re-running the query...")
    res2 = sess.search_typed(Query(qi, qv))
    st = sess.last_stats
    print(f"  failovers {st.failovers}, replica health "
          f"{sess.router.health()[owner]}")
    np.testing.assert_array_equal(res2.doc_ids, res.doc_ids)
    np.testing.assert_array_equal(res2.scores.view(np.uint32),
                                  res.scores.view(np.uint32))
    assert st.failovers == 1 and sess.router.health()[owner] == [False, True]
    print("OK: identical top-k with one replica dead")

    sess.close()
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
