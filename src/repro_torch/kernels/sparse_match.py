"""ELL sparse match (the paper's Key Comparator + Distance Accumulator):
backend ``gpu``, the port of ``repro.kernels.sparse_match``.

    out[d, l] = sum_k doc_vals[d, k] * sum_{q : q_ids[q] == doc_ids[d, k]}
                q_vals[q, l]

The TPU kernel builds the match matrix ``eq = doc_id == q_id`` and runs
``eq @ q_vals`` on the MXU. On the card (``csrc/sparse_match.cu``) each
document slot looks its id up in a hashed table of the query tile's
distinct ids in shared memory instead, as the packed and fused kernels
do (``table_plan``; what a stream gives the table, ``query_tiles``). The
table holds every non-negative id (``MAX_KEY``). ``sparse_match_plain``
is the same lookup in PyTorch: it is what the wrapper runs for CPU
tensors, and what the kernel is held against.

Sentinels: any negative id is padding, on either side (documents pad with
-1, the merged stream with -2); padding never matches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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


MAX_TILE_ITEMS = 8192         # csrc/match.cuh: kMaxTileItems
TABLE_MIN_SLOTS = 64          # csrc/match.cuh: kMinSlots
MIN_PASS_COLS = 4             # csrc/match.cuh: kMinPassCols (B1, B2)
MAX_KEY = (1 << 31) - 1       # csrc/sparse_match.cu: EllDocs::kMaxKey


def _pow2_slots(x: int) -> int:
    slots = TABLE_MIN_SLOTS
    while slots < x:
        slots *= 2
    return slots


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def query_tile_bytes(items: int) -> int:
    """Shared memory of the query tile of a stream whose largest tile has
    ``items`` items, past its scratch word (``csrc/match.cuh``
    ``query_tile_smem``): its ids and a table at load 1/2 for that many
    distinct ids. B3's query tile has this; B1's and B2's may have more
    (``tile_bytes``, ``sparse_match_packed.tile_bytes``)."""
    items = max(1, items)
    return _align16(4 * items) + _align16(2 * _pow2_slots(2 * items))


def table_plan(n_real: int, tile_bytes: int, cols: int,
               min_cols: int) -> Tuple[int, int]:
    """(slots, sum columns) of the hashed query table that B1-B3 build
    for a sorted query tile of ``n_real`` real items in ``tile_bytes`` of
    shared memory (``csrc/match.cuh`` ``table_plan``): the run sums of the
    widest of ``cols``, ``cols // 2``, ... down to ``min_cols`` columns
    that fit, beside a table of the least power of two >= 4 * n_real
    slots (at most a quarter taken) where that fits too, else >= 2 *
    n_real (at most half taken); if no sums fit, 0 columns (hits walk
    their runs) and the table at a quarter where it fits beside the ids,
    else at half, which always fits. At least 64 slots."""
    def fits(slots, c):
        return (_align16(4 * n_real) + _align16(2 * slots) + 4 * c * n_real
                <= tile_bytes)
    quarter, half = _pow2_slots(4 * n_real), _pow2_slots(2 * n_real)
    c = cols
    while c >= max(min_cols, 1):
        for slots in (quarter, half):
            if fits(slots, c):
                return slots, c
        c //= 2
    return (quarter if fits(quarter, 0) else half), 0


def query_tiles(q_ids, max_key: int, cols: int = 8, min_cols: int = 0,
                tile_bytes: int = 0) -> list:
    """What each 8192-item query tile of a merged stream gives the table
    of ``csrc/match.cuh``: its items, whether it is sorted under "pads
    sort last" (else no table: the full-tile scan), its real items (ids
    >= 0), the distinct ids <= ``max_key`` the table holds, and its slots
    and run-sum columns (None when unsorted), for passes of ``cols``
    columns that may narrow to ``min_cols`` (default ``cols``: B3's;
    ``MIN_PASS_COLS`` for B1 and B2) in ``tile_bytes`` (default
    ``query_tile_bytes``: B3's; ``tile_bytes`` for B1). At least one
    tile, as the kernels count them."""
    ids = torch.as_tensor(q_ids).cpu().long()
    items = max(1, min(ids.numel(), MAX_TILE_ITEMS))
    tile_bytes = tile_bytes or query_tile_bytes(items)
    out = []
    for t0 in range(0, max(ids.numel(), 1), MAX_TILE_ITEMS):
        tile = ids[t0:t0 + MAX_TILE_ITEMS]
        key = torch.where(tile < 0, torch.iinfo(torch.int64).max, tile)
        is_sorted = bool((key[1:] >= key[:-1]).all())
        real = tile[tile >= 0]
        slots, sum_cols = (table_plan(real.numel(), tile_bytes, cols,
                                      min_cols or cols)
                           if is_sorted else (None, None))
        out.append({
            "items": tile.numel(), "sorted": is_sorted,
            "real": real.numel(),
            "distinct": torch.unique(real[real <= max_key]).numel(),
            "slots": slots, "sum_cols": sum_cols})
    return out


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
        _build.count_launch(sparse_match)
    return out


sparse_match.launches = 0


def card_tile_bytes(name: str, device, Qm: int, L: int) -> int:
    """Shared memory of kernel library ``name``'s query tile on card
    ``device`` for a launch of ``Qm`` items and ``L`` columns, past its
    scratch word: what the kernel's registers leave a block
    (``csrc/match.cuh`` ``smem_share``, exported as ``<name>_smem``), at
    least ``query_tile_bytes``. Needs the card."""
    fn = _build.kernel(name, f"{name}_smem", [ctypes.c_int] * 3)
    smem = fn(torch.device(device).index or 0, Qm, L)
    if smem <= 0:
        raise RuntimeError(f"{name}_smem failed")
    return smem - 16


def tile_bytes(device, Qm: int, L: int) -> int:
    """B1's query tile on the card (``card_tile_bytes``), for
    ``query_tiles``'s report of its table."""
    return card_tile_bytes("sparse_match", device, Qm, L)
