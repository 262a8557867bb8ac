"""ELL sparse match (the paper's Key Comparator + Distance Accumulator):
backend ``gpu``, the port of ``repro.kernels.sparse_match``.

    out[d, l] = sum_k doc_vals[d, k] * sum_{q : q_ids[q] == doc_ids[d, k]}
                q_vals[q, l]

The TPU kernel builds the match matrix ``eq = doc_id == q_id`` and runs
``eq @ q_vals`` on the MXU. On the card (``csrc/sparse_match.cu``) each
document slot looks up the run of its id in the merged query stream
instead. ``sparse_match_plain`` is the same lookup in PyTorch: it is what
the wrapper runs for CPU tensors, and what the kernel is held against.

Sentinels: any negative id is padding, on either side (documents pad with
-1, the merged stream with -2); padding never matches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

QUERY_PAD = -2


def run_sums(ids: torch.Tensor, q_ids: torch.Tensor,
             q_vals: torch.Tensor) -> torch.Tensor:
    """For every id (any shape), the sum of ``q_vals`` rows over the query
    items carrying that id: ``ids.shape + (L,)``; 0 for a negative id or
    one the stream lacks. Duplicates in the stream add up."""
    L = q_vals.shape[1]
    real = q_ids >= 0
    uniq, inv = torch.unique(q_ids[real], sorted=True, return_inverse=True)
    if uniq.numel() == 0:
        return torch.zeros(ids.shape + (L,), dtype=torch.float32,
                           device=ids.device)
    runs = torch.zeros((uniq.numel(), L), dtype=torch.float32,
                       device=ids.device)
    runs.index_add_(0, inv, q_vals[real].float())
    pos = torch.searchsorted(uniq, ids.contiguous()).clamp(
        max=uniq.numel() - 1)
    hit = (ids >= 0) & (uniq[pos] == ids)
    return torch.where(hit[..., None], runs[pos], 0.0)


def sparse_match_plain(doc_ids: torch.Tensor, doc_vals: torch.Tensor,
                       q_ids: torch.Tensor, q_vals: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's function in PyTorch: [D, K] docs x merged stream ->
    correlation [D, L] fp32."""
    m = run_sums(doc_ids, q_ids, q_vals)                   # [D, K, L]
    pp = torch.where((doc_ids >= 0)[..., None],
                     doc_vals[..., None].float() * m, 0.0)
    return pp.sum(dim=1)


def _check_query(q_ids: torch.Tensor, q_vals: torch.Tensor) -> None:
    if q_ids.dim() != 1 or q_vals.dim() != 2 \
            or q_vals.shape[0] != q_ids.shape[0]:
        raise ValueError(f"query stream: ids {tuple(q_ids.shape)} must be "
                         f"[Qm] and vals {tuple(q_vals.shape)} [Qm, L]")
    if q_ids.dtype != torch.int32 or q_vals.dtype != torch.float32:
        raise TypeError(f"query stream must be int32 ids and float32 vals, "
                        f"got {q_ids.dtype} and {q_vals.dtype}")


def on_cpu(*tensors: torch.Tensor, contiguous: bool = True) -> bool:
    """True if every tensor lies on the CPU (the plain version's case);
    False if every one lies on one CUDA device (and, where ``contiguous``,
    is contiguous); raises otherwise."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all be on one CUDA device or all "
                         f"on the CPU, got {sorted(map(str, devices))}")
    for t in tensors:
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return False


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def sparse_match(doc_ids: torch.Tensor, doc_vals: torch.Tensor,
                 q_ids: torch.Tensor, q_vals: torch.Tensor) -> torch.Tensor:
    """doc_ids [D, K] int32 (pad < 0), doc_vals [D, K] float32, q_ids [Qm]
    int32 (pad < 0), q_vals [Qm, L] float32 -> correlation [D, L] float32.

    CPU tensors run ``sparse_match_plain``; CUDA tensors launch the
    kernel (counted in ``sparse_match.launches``) or raise."""
    if doc_ids.dim() != 2 or doc_vals.shape != doc_ids.shape:
        raise ValueError(f"docs: ids {tuple(doc_ids.shape)} and vals "
                         f"{tuple(doc_vals.shape)} must both be [D, K]")
    if doc_ids.dtype != torch.int32 or doc_vals.dtype != torch.float32:
        raise TypeError(f"docs must be int32 ids and float32 vals, got "
                        f"{doc_ids.dtype} and {doc_vals.dtype}")
    _check_query(q_ids, q_vals)
    if on_cpu(doc_ids, doc_vals, q_ids, q_vals):
        return sparse_match_plain(doc_ids, doc_vals, q_ids, q_vals)
    fn = _build.kernel("sparse_match", "sparse_match_launch", _ARGTYPES)
    D, K = doc_ids.shape
    Qm, L = q_vals.shape
    out = torch.empty((D, L), dtype=torch.float32, device=doc_ids.device)
    if out.numel():
        _build.check("sparse_match", fn(
            out.device.index, doc_ids.data_ptr(), doc_vals.data_ptr(),
            q_ids.data_ptr(), q_vals.data_ptr(), out.data_ptr(), D, K, Qm, L,
            stream_of(out)))
        sparse_match.launches += 1
    return out


sparse_match.launches = 0
