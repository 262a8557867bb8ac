"""The plain reference of exact sparse pattern search: cosine top-k.

For a query q and a document d, both bags of (word, count):

    score(q, d) = sum_w q[w] d[w] / (|q| |d|),  |x| = sqrt(sum_w x[w]^2)

taken in float32 (the configuration's precision): the sum of products of
integral counts is exact in any order while it stays below 2^24, the
norms are IEEE square roots of exact sums, and the cosine is one
float32 product and one division. The top-k of a query is the k largest
scores over every document.

It reads the harness's corpus (word ids and counts), never a slab,
norm or table that the program built, and it imports nothing of the
program: plain PyTorch, on the card or the CPU, a block of documents at
a time so that it fits beside nothing else. ``dtype=torch.bfloat16``
computes the same in bfloat16: the control that the comparison must
refuse.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# elements of the gathered [docs, slots, queries] block
_BLOCK_ELEMS = 1 << 28


class Answer(NamedTuple):
    doc_ids: np.ndarray       # [L, k] int64
    scores: np.ndarray        # [L, k] float32


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def query_matrix(queries: Sequence[Tuple[np.ndarray, np.ndarray]],
                 vocab_size: int, device, dtype) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """([vocab + 1, P] query counts by word, row ``vocab`` all zero for a
    padding slot; [P] query norms)."""
    qd = torch.zeros((vocab_size + 1, len(queries)), dtype=dtype,
                     device=device)
    for p, (ids, vals) in enumerate(queries):
        keep = np.asarray(ids) >= 0
        qd[torch.as_tensor(np.asarray(ids)[keep].astype(np.int64),
                           device=device), p] = torch.as_tensor(
            np.asarray(vals)[keep], device=device).to(dtype)
    return qd, _sqrt((qd * qd).sum(0))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # IEEE float32 square root on the CPU too: float64, rounded once more
    return torch.sqrt(x.double()).to(x.dtype)


def cosines(ids: torch.Tensor, vals: torch.Tensor, qd: torch.Tensor,
            qn: torch.Tensor) -> torch.Tensor:
    """[n, P] cosines of n documents ([n, K] ids, pad < 0; counts) with
    the P queries of ``query_matrix``."""
    _no_tf32()
    dt = qd.dtype
    n, K = ids.shape
    slot = torch.where(ids >= 0, ids.to(torch.int64), qd.shape[0] - 1)
    v = vals.to(dt)
    out = torch.empty((n, qd.shape[1]), dtype=dt, device=qd.device)
    step = max(1, _BLOCK_ELEMS // max(1, K * qd.shape[1]))
    for a in range(0, n, step):
        g = qd.index_select(0, slot[a:a + step].reshape(-1))
        g = g.view(-1, K, qd.shape[1])
        corr = torch.bmm(v[a:a + step, None, :], g)[:, 0, :]
        dn = _sqrt((v[a:a + step] * v[a:a + step]).sum(1))
        out[a:a + step] = corr / (dn[:, None] * qn[None, :])
    return out


class TopK:
    """The reference's answers for a pool of queries, fed the corpus a
    chunk at a time: each query's k best scores, and the score of every
    (query, document) pair asked for."""

    def __init__(self, queries, vocab_size: int, k: int,
                 pairs: Dict[int, Sequence[int]], device,
                 dtype=torch.float32):
        self.qd, self.qn = query_matrix(queries, vocab_size, device, dtype)
        self.k = k
        self.best = torch.full((0, len(queries)), -torch.inf, dtype=dtype,
                               device=device)
        q, d = [], []
        for p, docs in pairs.items():
            for doc in docs:
                q.append(p)
                d.append(doc)
        order = np.argsort(np.asarray(d, np.int64), kind="stable")
        self.pair_q = np.asarray(q, np.int64)[order]
        self.pair_d = np.asarray(d, np.int64)[order]
        self.pair_s = np.full(self.pair_d.size, np.nan, np.float32)

    def add(self, d0: int, ids: torch.Tensor, vals: torch.Tensor) -> None:
        """Documents ``d0 .. d0 + n`` ([n, K] ids and counts)."""
        cos = cosines(ids, vals, self.qd, self.qn)
        both = torch.cat([self.best, cos], 0)
        self.best = torch.topk(both, min(self.k, both.shape[0]), dim=0).values
        lo, hi = np.searchsorted(self.pair_d, [d0, d0 + ids.shape[0]])
        if hi > lo:
            rows = torch.as_tensor(self.pair_d[lo:hi] - d0, device=ids.device)
            c = cosines(ids[rows], vals[rows], self.qd, self.qn)
            cols = torch.as_tensor(self.pair_q[lo:hi], device=ids.device)
            s = c.gather(1, cols[:, None])[:, 0]
            self.pair_s[lo:hi] = s.float().cpu().numpy()

    def top_scores(self) -> np.ndarray:
        """[P, k] each query's k best scores, descending."""
        return self.best.T.float().cpu().numpy()

    def pair_scores(self) -> Dict[Tuple[int, int], float]:
        return {(int(q), int(d)): float(s) for q, d, s in
                zip(self.pair_q, self.pair_d, self.pair_s)}


class Searcher:
    """The reference put in the program's place: ``search(q_ids, q_vals)``
    ([L, Qn], pad < 0) over a resident corpus, in ``dtype``. Ties break
    by whatever ``torch.topk`` gives."""

    def __init__(self, ids: torch.Tensor, vals: torch.Tensor,
                 vocab_size: int, k: int, dtype=torch.float32):
        self.ids, self.vals = ids, vals
        self.vocab_size, self.k, self.dtype = vocab_size, k, dtype

    def search(self, q_ids: np.ndarray, q_vals: np.ndarray) -> Answer:
        qs = [(q_ids[i], q_vals[i]) for i in range(q_ids.shape[0])]
        qd, qn = query_matrix(qs, self.vocab_size, self.ids.device,
                              self.dtype)
        best_v = torch.full((0, len(qs)), -torch.inf, dtype=self.dtype,
                            device=self.ids.device)
        best_i = torch.zeros((0, len(qs)), dtype=torch.int64,
                             device=self.ids.device)
        step = max(1 << 16, _BLOCK_ELEMS // (self.ids.shape[1] * len(qs)))
        for a in range(0, self.ids.shape[0], step):
            cos = cosines(self.ids[a:a + step], self.vals[a:a + step], qd, qn)
            idx = torch.arange(a, a + cos.shape[0],
                               device=cos.device)[:, None].expand_as(cos)
            v = torch.cat([best_v, cos], 0)
            i = torch.cat([best_i, idx], 0)
            best_v, top = torch.topk(v, min(self.k, v.shape[0]), dim=0)
            best_i = i.gather(0, top)
        return Answer(best_i.T.cpu().numpy(), best_v.T.float().cpu().numpy())


def served_pairs(answers: List[tuple]) -> Dict[int, List[int]]:
    """query -> the distinct valid document ids the program served it."""
    out: Dict[int, set] = {}
    for q, _, _, ids, _ in answers:
        out.setdefault(q, set()).update(int(d) for d in ids if d >= 0)
    return {q: sorted(s) for q, s in out.items()}
