"""The comparison that decides ``correct``.

Every answer that the window's clients received is held to the plain
reference (``reference.py``) of its own query, over the whole corpus:

- ``lost``: queries submitted in the window whose answer never came or
  raised. Limit 0.
- ``rank_gap``: the largest |served score - reference score| at any rank
  of any answer (both lists descending). It catches a wrong ranking, a
  missed document, a query answered with another's row or none.
- ``id_gap``: the largest |served score - reference score of the served
  document| over every served (document, score) entry. It catches an
  id altered after its score was taken. An entry with an invalid or
  repeated id reads 1.

A missing score reads 1: the largest gap two cosines of non-negative
counts can have; so do both gaps of a run that checked no answer. The limits are set from readings of sound runs and of
the bfloat16 control (PERF.md, "Cells").
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

LIMITS = {"lost": 0, "rank_gap": 1e-4, "id_gap": 1e-4}


def compare(answers: List[tuple], lost: int, ref_top: np.ndarray,
            pair_scores: Dict[tuple, float], n_docs: int) -> Dict[str, float]:
    """The numbers compared, from the answers checked ((query, t0, t1,
    ids, scores) each), the queries ``lost``, and the reference's [Q, k]
    top scores and (query, doc) scores of those queries."""
    out = {"lost": float(lost), "rank_gap": 0.0, "id_gap": 0.0}
    if not answers:
        # a run that checked nothing has shown nothing
        out["rank_gap"] = out["id_gap"] = 1.0
        return out
    q = np.asarray([a[0] for a in answers], np.int64)
    ids = np.stack([np.asarray(a[3], np.int64) for a in answers])
    sc = np.stack([np.asarray(a[4], np.float64) for a in answers])
    k = ref_top.shape[1]
    if ids.shape[1] != k:
        out["rank_gap"] = out["id_gap"] = 1.0
        return out
    gap = np.abs(sc - ref_top[q].astype(np.float64))
    gap[~np.isfinite(gap)] = 1.0
    out["rank_gap"] = float(min(1.0, gap.max()))
    ok = (ids >= 0) & (ids < n_docs)
    srt = np.sort(ids, axis=1)
    dup = np.zeros_like(ok)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    repeated = np.zeros(len(ids), bool)
    repeated[np.nonzero(dup & (srt >= 0))[0]] = True
    ref = np.array([pair_scores.get((int(qq), int(d)), np.nan)
                    for qq, row in zip(q, ids) for d in row],
                   np.float64).reshape(ids.shape)
    igap = np.abs(sc - ref)
    igap[~(ok & np.isfinite(igap))] = 1.0
    igap[repeated] = 1.0
    out["id_gap"] = float(min(1.0, igap.max()))
    return out


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())


def report(numbers: Dict[str, float]) -> Dict[str, dict]:
    return {name: {"value": numbers[name], "limit": limit}
            for name, limit in LIMITS.items()}
