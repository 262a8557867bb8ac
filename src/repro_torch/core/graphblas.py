"""GraphBLAS-style kernels over the engine's ELL format (paper §VI:
"We are also currently developing GraphBLAS compliant operations in our
system for common graph and sparse linear algebra problems").

The adjacency matrix reuses the corpus ELL layout (ids [n, K] = neighbor
indices, -1 padded; vals [n, K] = edge weights), so the machinery that
streams corpus rows serves graph kernels too. Three
core semirings + PageRank (the paper cites the PageRank Pipeline Benchmark
[22]) and BFS as worked examples.

A copy of ``repro.core.graphblas`` as plain PyTorch: each function runs
on the device of its inputs, gathers with ``-1`` padding read as the
semiring's fill, then reduces over K, as the reference computes it. The
reference has no Pallas kernel here, so neither does the port.
``jax.lax.scan`` becomes a Python loop; ``bfs_levels`` still defaults to
``n`` iterations.
"""
from __future__ import annotations

import torch

INF = float("inf")


def _gather(x: torch.Tensor, ids: torch.Tensor, fill: float) -> torch.Tensor:
    """x[ids] with -1 padding -> fill."""
    safe = ids.clamp(0, x.shape[0] - 1)
    return torch.where(ids >= 0, x[safe], fill)


def spmv_plus_times(ids: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Standard (+, *) semiring: y = A @ x. ids/vals: [n, K]."""
    g = _gather(x, ids, 0.0)
    return (vals * g).sum(dim=1)


def spmv_min_plus(ids: torch.Tensor, vals: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(min, +) semiring: shortest-path relaxation step."""
    g = _gather(x, ids, INF)
    cand = torch.where(ids >= 0, vals + g, INF)
    return torch.minimum(x, cand.amin(dim=1))


def spmv_max_times(ids: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """(max, *) semiring: max-reliability / widest-path style."""
    g = _gather(x, ids, 0.0)
    return torch.maximum(x, (vals * g).amax(dim=1))


def out_degree(ids: torch.Tensor) -> torch.Tensor:
    return (ids >= 0).sum(dim=1)


def pagerank(ids_in: torch.Tensor, vals_in: torch.Tensor,
             out_deg: torch.Tensor, *, damping: float = 0.85,
             iters: int = 50) -> torch.Tensor:
    """PageRank over an *incoming*-edges ELL (row r lists sources s with
    edge weight 1): pr = (1-d)/n + d * A_in @ (pr / out_deg)."""
    n = ids_in.shape[0]
    pr = torch.full((n,), 1.0 / n, dtype=torch.float32, device=ids_in.device)
    deg = out_deg.to(torch.float32).clamp_min(1.0)
    dangling_rows = out_deg == 0
    for _ in range(iters):
        contrib = spmv_plus_times(ids_in, vals_in, pr / deg)
        # dangling mass redistributed uniformly
        dangling = torch.where(dangling_rows, pr, 0.0).sum()
        pr = (1 - damping) / n + damping * (contrib + dangling / n)
    return pr


def bfs_levels(ids_out: torch.Tensor, src: int,
               max_iters: int = 0) -> torch.Tensor:
    """BFS level per vertex via (min, +) relaxation on unit weights."""
    n = ids_out.shape[0]
    iters = max_iters or n
    dist = torch.full((n,), INF, dtype=torch.float32, device=ids_out.device)
    dist[src] = 0.0
    ones = torch.ones(ids_out.shape, dtype=torch.float32,
                      device=ids_out.device)
    # relax along OUT edges: dist[v] = min(dist[v], min_u->v dist[u]+1);
    # ids_out rows must list incoming neighbors for pull-style relaxation,
    # so callers pass the reversed adjacency (see tests)
    for _ in range(iters):
        dist = spmv_min_plus(ids_out, ones, dist)
    return dist
