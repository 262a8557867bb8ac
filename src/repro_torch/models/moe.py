"""Mixture-of-Experts block on one card: the port of ``repro.models.moe``.

The reference dispatches under ``shard_map`` over a mesh of M expert
shards: router top-k, a send-side sort by destination shard cut to
``cap_send`` slots a shard, an ``all_to_all``, a per-expert SwiGLU over
capacity-sized windows of the sorted buffer, an ``all_to_all`` back and a
weighted scatter-add combine. On one card M = 1: both ``all_to_all``s,
the FSDP ``all_gather`` of the expert weights and the ``pmean``s of the
aux loss are identities, and the send-side sort keeps the flat
(token, choice) order. What stays is the reference's arithmetic and its
drops, step by step:

  - router: ``x @ router`` with the router rounded to x's dtype and the
    products summed in f32 (the reference's default ``router_bf16_matmul``
    flag; in f32 it is ``x @ router``), softmax, top-k with the lower
    expert first among equal probabilities (``jax.lax.top_k``'s order: a
    stable descending sort), weights renormalised by ``max(sum, 1e-9)``;
  - aux loss ``E · Σ_e mean_t(probs) · count_e / (T·k)``;
  - capacity: the first ``cap_send = ceil(T·k·cf)`` assignments are sent
    (with cf >= 1, all); the buffer is sorted by expert (stable), and
    expert e computes the ``cap_exp = min(ceil(N/E·cf), N)`` rows
    ``[clip(start_e, 0, N - cap_exp), +cap_exp)`` of it, keeping only
    those inside its own ``[start_e, start_e + count_e)``: an expert's
    assignments past its window are dropped (ROADMAP C17);
  - combine: each token's k weighted expert outputs summed in top-k order
    in x's dtype, rounding at each add, as the reference's scatter-add
    applies them (ROADMAP C18); dropped choices add nothing.

The expert products are three ``torch.bmm`` over ``[E, cap_exp, d]``
windows gathered on the device, with no host sync (every index is a
gather or a permutation): plain large products, which the reference also
leaves to XLA outside any Pallas kernel.

Two hooks for checks, both ``None`` on the serving path:

  - ``moe_apply.record``: a list to which every call appends
    ``{"tokens", "expert_id" [T, k], "kept" [T, k] bool, "dropped",
    "own_id" [T, k], "margin" [T]}``: ``own_id`` is the router's own
    choice and ``margin`` its router-logit gap between the k-th and the
    (k+1)-th expert (the count syncs with the host, so only when
    recording);
  - ``moe_apply.replay``: a list of ``[T, k]`` expert ids, one a call,
    taken in order in place of the router's choice (gate weights are the
    router's probabilities at those ids, renormalised), so that two runs
    of a model can be held to one routing.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's MoE params: router f32 ``[d, E]``; ``w_gate``, ``w_up``
    ``[E, d, ff]`` and ``w_down`` ``[E, ff, d]`` in the config's dtype;
    a SwiGLU ``shared`` expert of ``n_shared_experts · ff`` when there is
    one. Truncated normals at ±3σ with std 1/sqrt(d_in), as the
    reference."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.dtype)

    def trunc(shape, std):
        w = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return w.mul_(std)

    p = {"router": trunc((d, E), 1.0 / math.sqrt(d)),
         "w_gate": trunc((E, d, ff), 1.0 / math.sqrt(d)).to(dtype),
         "w_up": trunc((E, d, ff), 1.0 / math.sqrt(d)).to(dtype),
         "w_down": trunc((E, ff, d), 1.0 / math.sqrt(ff)).to(dtype)}
    if cfg.n_shared_experts > 0:
        ff_sh = cfg.n_shared_experts * ff
        p["shared"] = {"w_gate": L.dense_init(gen, d, ff_sh, dtype),
                       "w_up": L.dense_init(gen, d, ff_sh, dtype),
                       "w_down": L.dense_init(gen, ff_sh, d, dtype)}
    return p


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x [T, d] -> (gate weights [T, k] f32, expert ids [T, k] int64,
    probs [T, E] f32, router logits [T, E] f32)."""
    logits = x.float() @ router.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, expert_id = top.values[:, :k], top.indices[:, :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gate_w, expert_id, probs, logits


def capacities(T: int, cfg: ModelConfig):
    """(cap_send, cap_exp) for T tokens on one device (the reference's
    expressions at M = 1)."""
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    cap_send = int(math.ceil(T * k / 1 * cf))
    return cap_send, min(int(math.ceil(cap_send / max(E, 1) * cf)), cap_send)


def _dispatch(x: torch.Tensor, p: dict, cfg: ModelConfig, expert_id=None):
    """x [T, d] -> (y [T, d] in x's dtype, aux f32 scalar, expert ids
    [T, k], kept [T, k] bool, the router's (own ids, logits)).
    ``expert_id``: a routing to use in place of the router's."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    gate_w, own_id, probs, logits = route(x, p["router"], k)
    if expert_id is None:
        expert_id = own_id
    else:
        gate_w = probs.gather(1, expert_id)
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, expert_id.reshape(-1),
        torch.full((T * k,), 1.0 / (T * k), dtype=torch.float32, device=dev))
    aux = E * torch.sum(probs.mean(dim=0) * ce)

    # send side: slot i holds assignment i (token i // k, choice i % k)
    # while i < cap_send; the rest are dropped
    N, cap = capacities(T, cfg)
    n_send = min(T * k, N)
    flat_eid = expert_id.reshape(-1)[:n_send]
    send_x = torch.zeros((N, d), dtype=x.dtype, device=dev)
    send_x[:n_send] = x.repeat_interleave(k, dim=0)[:n_send]
    send_le = torch.full((N,), E, dtype=torch.int64, device=dev)
    send_le[:n_send] = flat_eid

    # expert side: sort by expert (empty slots, id E, last), then expert
    # e computes the window of cap rows from first[e]
    le_sorted, order = torch.sort(send_le, stable=True)
    counts = torch.bincount(le_sorted, minlength=E + 1)[:E]
    starts = torch.cumsum(counts, 0) - counts
    first = torch.clamp(starts, 0, max(N - cap, 0))
    window = first[:, None] + torch.arange(cap, device=dev)      # [E, cap]
    rows = send_x[order[window]]                                 # [E, cap, d]
    h = L.silu(torch.bmm(rows, p["w_gate"])) * torch.bmm(rows, p["w_up"])
    out = torch.bmm(h, p["w_down"])                              # [E, cap, d]
    # sorted row n is its expert's row n - first: kept if inside the
    # window (it is inside the expert's own range by construction)
    owner = torch.clamp(le_sorted, max=E - 1)
    at = torch.arange(N, device=dev) - first[owner]
    computed = (le_sorted < E) & (at < cap)
    ys = torch.where(computed[:, None],
                     out[owner, torch.clamp(at, max=cap - 1)],
                     torch.zeros((), dtype=x.dtype, device=dev))

    # back in slot order; combine each token's choices in top-k order
    back = torch.empty_like(ys)
    back[order] = ys
    kept_slot = torch.empty_like(computed)
    kept_slot[order] = computed
    contrib = torch.zeros((T * k, d), dtype=x.dtype, device=dev)
    contrib[:n_send] = back[:n_send] * gate_w.reshape(-1)[:n_send, None].to(
        x.dtype)
    contrib = contrib.view(T, k, d)
    y = torch.zeros((T, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    kept = torch.zeros(T * k, dtype=torch.bool, device=dev)
    kept[:n_send] = kept_slot[:n_send]
    return y, aux, expert_id, kept.view(T, k), (own_id, logits)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, d] -> (y [B, S, d], aux f32 scalar). ``p`` holds one
    layer: router ``[d, E]``, ``w_gate``/``w_up`` ``[E, d, ff]``,
    ``w_down`` ``[E, ff, d]``, optionally ``shared``."""
    B, S, d = x.shape
    forced = moe_apply.replay.pop(0) if moe_apply.replay is not None \
        else None
    y, aux, expert_id, kept, (own_id, logits) = _dispatch(
        x.reshape(B * S, d), p, cfg, forced)
    if moe_apply.record is not None:
        k = cfg.top_k
        top = logits.topk(min(k + 1, cfg.n_experts), dim=-1).values
        margin = top[:, k - 1] - top[:, k] if cfg.n_experts > k \
            else torch.full_like(top[:, 0], float("inf"))
        moe_apply.record.append({"tokens": B * S, "expert_id": expert_id,
                                 "kept": kept,
                                 "dropped": int((~kept).sum()),
                                 "own_id": own_id, "margin": margin})
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + L.ffn_apply(p["shared"], x)
    return y, aux


moe_apply.record = None
moe_apply.replay = None
