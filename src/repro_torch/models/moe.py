"""Mixture-of-Experts block with expert parallelism: the port of
``repro.models.moe``.

The reference dispatches under ``shard_map`` over a mesh of M expert
shards (the ``model`` axis): router top-k, a send-side sort by
destination shard cut to ``cap_send`` slots a shard, an ``all_to_all``,
a per-expert SwiGLU over capacity-sized windows of the sorted buffer, an
``all_to_all`` back and a weighted scatter-add combine. The port runs
those three phases (``_send``, ``_experts``, ``_combine``) three ways:

  - on one card (no ``MeshWeights``), M = 1: both ``all_to_all``s, the
    FSDP gather of the expert weights and the ``pmean``s of the aux loss
    are identities, and the send side skips its sort (one destination:
    slot i holds assignment i, in flat (token, choice) order) and the
    combine its reordering, as the decode step is host-bound and pays
    for every op;
  - on a mesh (``_moe_mesh``), each rank one shard: tokens ``[B/dp,
    S/M, d]`` where ``S % M == 0 and S >= M``, else the rank's batch
    block whole (a decode step at S = 1: every model rank sends the same
    tokens, and each expert shard computes M copies); the expert weights
    ``[E/M, d, ff]`` gathered over ``fsdp``; the ``all_to_all``s over
    ``model`` through ``distributed/compat.py``; the aux's ``me`` and
    ``ce`` ``pmean``ed over ``model`` and the aux over the dp axes;
  - ``dispatch_simulated``: the M shards' bodies in one process, each
    ``all_to_all`` a transpose of ``[M, M, cap_send, d]``; the plain
    version of the mesh path, for checks (nothing serves through it).

Capacities are per shard (``capacities``), so a mesh drops other
assignments than one card does (ROADMAP C26). The arithmetic and the
drops, step by step:

  - router: ``x @ router`` with the router rounded to x's dtype and the
    products summed in f32 (the reference's default ``router_bf16_matmul``
    flag; in f32 it is ``x @ router``), softmax, top-k with the lower
    expert first among equal probabilities (``jax.lax.top_k``'s order: a
    stable descending sort), weights renormalised by ``max(sum, 1e-9)``;
  - aux loss ``E · Σ_e mean_t(probs) · count_e / (T·k)``;
  - send side: the T·k assignments sorted stably by destination shard
    (expert id // E_loc), the first ``cap_send = ceil(T·k/M·cf)`` of each
    shard sent; on one card (M = 1, cf >= 1) all, in flat order;
  - expert side: the M·cap_send = N received rows sorted stably by local
    expert id, and local expert e computes the ``cap_exp = min(ceil(N /
    E_loc·cf), N)`` rows ``[clip(start_e, 0, N - cap_exp), +cap_exp)``
    of them, keeping only those inside its own ``[start_e, start_e +
    count_e)``: an expert's assignments past its window are dropped
    (ROADMAP C17);
  - combine: each token's weighted expert outputs summed in x's dtype,
    rounding at each add, in the order of their send slots, as the
    reference's scatter-add applies them: by destination shard, then in
    top-k order; on one card, top-k order (ROADMAP C18); dropped choices
    add nothing.

The expert products are three ``torch.bmm`` over ``[E_loc, cap_exp,
d]`` windows gathered on the device, with no host sync (every index is a
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

On a mesh a ``record`` entry holds ``{"tokens", "x", "y",
"expert_id", "own_id", "margin", "dropped"}``: the rank's residual
block in, its routed output (before the shared expert), the ids and
margins of the tokens it routed, and the assignments this rank's send side cut plus those its
experts received and did not compute (summed over the ``model`` ranks,
a layer's drops). A ``replay`` entry there is the whole batch's ``[B·S,
k]`` ids, as one device records them; each rank takes its tokens'.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L



def moe_init(gen: torch.Generator, cfg: ModelConfig, keep=L.whole) -> dict:
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

    p = {"router": keep(("router",), trunc((d, E), 1.0 / math.sqrt(d))),
         "w_gate": keep(("w_gate",),
                        trunc((E, d, ff), 1.0 / math.sqrt(d)).to(dtype)),
         "w_up": keep(("w_up",),
                      trunc((E, d, ff), 1.0 / math.sqrt(d)).to(dtype)),
         "w_down": keep(("w_down",),
                        trunc((E, ff, d), 1.0 / math.sqrt(ff)).to(dtype))}
    if cfg.n_shared_experts > 0:
        ff_sh = cfg.n_shared_experts * ff
        sh = L.under(keep, "shared")
        p["shared"] = {
            "w_gate": sh(("w_gate",), L.dense_init(gen, d, ff_sh, dtype)),
            "w_up": sh(("w_up",), L.dense_init(gen, d, ff_sh, dtype)),
            "w_down": sh(("w_down",), L.dense_init(gen, ff_sh, d, dtype))}
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


def route_margin(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The router-logit gap between each token's k-th and (k+1)-th
    expert, [T] (inf where every expert is chosen)."""
    if logits.shape[-1] <= k:
        return torch.full_like(logits[:, 0], float("inf"))
    top = logits.topk(k + 1, dim=-1).values
    return top[:, k - 1] - top[:, k]


def capacities(T: int, cfg: ModelConfig, M: int = 1):
    """(cap_send, cap_exp) for T tokens on one of M expert shards (the
    reference's expressions: ``cap_send = ceil(T·k/M·cf)`` slots a
    destination shard, ``cap_exp = min(ceil(N/E_loc·cf), N)`` rows a
    local expert, N = M·cap_send)."""
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    cap_send = int(math.ceil(T * k / M * cf))
    N = M * cap_send
    return cap_send, min(int(math.ceil(N / max(E // M, 1) * cf)), N)


def _send(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, M: int,
          expert_id=None) -> dict:
    """One shard's send side: route its tokens x [T, d], sort the
    assignments stably by destination shard and cut each shard's to
    ``cap_send``. ``expert_id``: a routing to use in place of the
    router's. Returns the send buffers ``send_x`` [M, cap_send, d] and
    ``send_le`` [M, cap_send] (local expert ids, E_loc for an empty
    slot), and what the combine needs: each assignment's ``slot`` (N
    where dropped) and ``dest`` (both ``None`` at M = 1, where slot i
    is assignment i), ``gate_w``, the aux's ``me`` and ``ce``."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // M
    dev = x.device
    gate_w, own_id, probs, logits = route(x, router, k)
    if expert_id is None:
        expert_id = own_id
    else:
        gate_w = probs.gather(1, expert_id)
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, expert_id.reshape(-1),
        torch.full((T * k,), 1.0 / (T * k), dtype=torch.float32, device=dev))

    cap, _ = capacities(T, cfg, M)
    N = M * cap
    flat_eid = expert_id.reshape(-1)
    dest = slot = None
    if M == 1:      # one shard: slot i holds assignment i while i < N
        n = min(T * k, N)
        send_x = torch.zeros((N, d), dtype=x.dtype, device=dev)
        send_x[:n] = x.repeat_interleave(k, dim=0)[:n]
        send_le = torch.full((N,), E_loc, dtype=torch.int64, device=dev)
        send_le[:n] = flat_eid[:n]
    else:
        dest = flat_eid // E_loc
        s_dest, order = torch.sort(dest, stable=True)
        counts = torch.bincount(s_dest, minlength=M)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(T * k, device=dev) - starts[s_dest]
        slot_sorted = torch.where(pos < cap, s_dest * cap + pos,
                                  torch.full_like(pos, N))
        # one spare row takes every dropped assignment, then is cut away
        send_x = torch.zeros((N + 1, d), dtype=x.dtype, device=dev)
        send_x[slot_sorted] = x[order // k]
        send_le = torch.full((N + 1,), E_loc, dtype=torch.int64, device=dev)
        send_le[slot_sorted] = flat_eid[order] % E_loc
        slot = torch.empty_like(slot_sorted)
        slot[order] = slot_sorted
    return {"M": M, "send_x": send_x[:N].view(M, cap, d),
            "send_le": send_le[:N].view(M, cap), "slot": slot,
            "dest": dest, "gate_w": gate_w, "expert_id": expert_id,
            "me": probs.mean(dim=0), "ce": ce, "own_id": own_id,
            "logits": logits}


def _experts(recv_x: torch.Tensor, recv_le: torch.Tensor, w_gate, w_up,
             w_down, cap: int):
    """One shard's local experts over the N rows it received, [N, d] and
    their local expert ids [N]: (outputs [N, d] in the received order,
    zero where not computed; computed [N] bool). The products are three
    ``torch.bmm`` over ``[E_loc, cap, d]`` windows gathered on the
    device, with no host sync."""
    N = recv_x.shape[0]
    E_loc = w_gate.shape[0]
    dev = recv_x.device
    le_sorted, order = torch.sort(recv_le, stable=True)
    counts = torch.bincount(le_sorted, minlength=E_loc + 1)[:E_loc]
    starts = torch.cumsum(counts, 0) - counts
    first = torch.clamp(starts, 0, max(N - cap, 0))
    window = first[:, None] + torch.arange(cap, device=dev)   # [E_loc, cap]
    rows = recv_x[order[window]]                               # [E_loc, cap, d]
    h = L.silu(torch.bmm(rows, w_gate)) * torch.bmm(rows, w_up)
    out = torch.bmm(h, w_down)                                 # [E_loc, cap, d]
    # sorted row n is its expert's row n - first: kept if inside the
    # window (it is inside the expert's own range by construction)
    owner = torch.clamp(le_sorted, max=E_loc - 1)
    at = torch.arange(N, device=dev) - first[owner]
    computed = (le_sorted < E_loc) & (at < cap)
    ys = torch.where(computed[:, None],
                     out[owner, torch.clamp(at, max=cap - 1)],
                     torch.zeros((), dtype=recv_x.dtype, device=dev))
    back = torch.empty_like(ys)
    back[order] = ys
    done = torch.empty_like(computed)
    done[order] = computed
    return back, done


def _combine(back: torch.Tensor, s: dict, dtype: torch.dtype,
             done=None):
    """One shard's combine from what came back [N, d] (``done``: which
    slots an expert computed, for ``kept``): (y [T, d] in ``dtype``, kept
    [T, k] bool or None). Each token's choices add in the order of their
    slots: by destination shard, then in top-k order."""
    slot, dest = s["slot"], s["dest"]
    T, k = s["expert_id"].shape
    N, d = back.shape
    gate_w = s["gate_w"].reshape(-1)[:, None].to(dtype)
    if s["M"] == 1:     # slot i is assignment i, while i < N
        n = min(T * k, N)
        contrib = torch.zeros((T * k, d), dtype=dtype, device=back.device)
        contrib[:n] = back[:n] * gate_w[:n]
        contrib = contrib.view(T, k, d)
    else:
        sent = slot < N
        rows = back[torch.clamp(slot, max=N - 1)]
        contrib = torch.where(sent[:, None], rows * gate_w,
                              torch.zeros((), dtype=dtype,
                                          device=back.device))
        key = dest.view(T, k) * k + torch.arange(k, device=back.device)
        perm = torch.argsort(key, dim=1, stable=True)
        contrib = contrib.view(T, k, d).gather(
            1, perm[..., None].expand(T, k, d))
    y = torch.zeros((T, d), dtype=dtype, device=back.device)
    for j in range(k):
        y = y + contrib[:, j]
    kept = None
    if done is not None and s["M"] == 1:
        kept = torch.zeros(T * k, dtype=torch.bool, device=back.device)
        kept[:n] = done[:n]
        kept = kept.view(T, k)
    elif done is not None:
        kept = (sent & done[torch.clamp(slot, max=N - 1)]).view(T, k)
    return y, kept


def _aux(cfg: ModelConfig, me, ce):
    return cfg.n_experts * torch.sum(me * ce)


def _dispatch(x: torch.Tensor, p: dict, cfg: ModelConfig, expert_id=None):
    """One card: x [T, d] -> (y [T, d] in x's dtype, aux f32 scalar,
    expert ids [T, k], kept [T, k] bool, the router's (own ids,
    logits)). ``expert_id``: a routing to use in place of the router's."""
    T, d = x.shape
    s = _send(x, p["router"], cfg, 1, expert_id)
    _, cap_exp = capacities(T, cfg)
    back, done = _experts(s["send_x"].view(-1, d), s["send_le"].view(-1),
                          p["w_gate"], p["w_up"], p["w_down"], cap_exp)
    y, kept = _combine(back, s, x.dtype, done)
    return (y, _aux(cfg, s["me"], s["ce"]), s["expert_id"], kept,
            (s["own_id"], s["logits"]))


def _token_block(S: int, M: int, r: int):
    """The sequence block a model rank dispatches: S/M positions where
    they divide (and S >= M), else all of them."""
    if S % M == 0 and S >= M:
        return slice(r * S // M, (r + 1) * S // M)
    return slice(0, S)


def dispatch_simulated(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       dp: int, M: int):
    """The mesh's MoE block on a dp x M mesh, its shards' bodies run in
    one process: x [B, S, d] whole (B divisible by dp), ``p`` one layer's
    whole params -> (y [B, S, d], aux), what ``moe_apply`` gives on such
    a mesh (model rank 0's copy where the tokens are replicated over
    ``model``). Each ``all_to_all`` is a transpose of ``[M, M, cap_send,
    d]``; the shared expert, where there is one, runs on one device. The
    plain version of ``_moe_mesh``, for checks."""
    B, S, d = x.shape
    E = cfg.n_experts
    if E % M or B % dp:
        raise ValueError(f"{E} experts over {M} shards, batch {B} over {dp}")
    E_loc = E // M
    Bl = B // dp
    ys, auxes = [], []
    for g in range(dp):
        xb = x[g * Bl:(g + 1) * Bl]
        blocks = [xb[:, _token_block(S, M, r)] for r in range(M)]
        sends = [_send(b.reshape(-1, d), p["router"], cfg, M)
                 for b in blocks]
        T = blocks[0].shape[0] * blocks[0].shape[1]
        cap, cap_exp = capacities(T, cfg, M)
        sx = torch.stack([s["send_x"] for s in sends])     # [src, dst, cap, d]
        sl = torch.stack([s["send_le"] for s in sends])
        outs = []
        for r in range(M):
            w = slice(r * E_loc, (r + 1) * E_loc)
            back, _ = _experts(sx[:, r].reshape(-1, d), sl[:, r].reshape(-1),
                               p["w_gate"][w], p["w_up"][w], p["w_down"][w],
                               cap_exp)
            outs.append(back.view(M, cap, d))               # [src, cap, d]
        back = torch.stack(outs, dim=1)                     # [src, dst, ...]
        y = [_combine(back[r].reshape(-1, d), sends[r], x.dtype)[0]
             for r in range(M)]
        if S % M == 0 and S >= M:
            ys.append(torch.cat([t.view(Bl, S // M, d) for t in y], dim=1))
        else:
            ys.append(y[0].view(Bl, S, d))
        me = torch.stack([s["me"] for s in sends]).sum(0) / M
        ce = torch.stack([s["ce"] for s in sends]).sum(0) / M
        auxes.append(_aux(cfg, me, ce))
    y = torch.cat(ys, dim=0)
    if "shared" in p:
        y = y + L.ffn_apply(p["shared"], x)
    return y, torch.stack(auxes).sum() / dp


def _moe_mesh(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The rank's MoE block on a mesh: x [B_loc, S, d] its residual
    block (replicated over ``model``) -> (y [B_loc, S, d], aux).
    ``mesh``: the forward's ``layers.MeshWeights``."""
    from repro_torch.distributed import compat
    ctx = mesh.ctx
    B, S, d = x.shape
    M, r, tp = ctx.tp_size, ctx.coord(ctx.tp_axis), ctx.tp_axis
    E = cfg.n_experts
    if E % M:
        raise ValueError(f"{cfg.name}: {E} experts do not split over the "
                         f"{M} ranks of {tp!r}")
    ff = cfg.d_ff
    wg, _ = mesh.weight(p["w_gate"], ("moe", "w_gate"), (E, d, ff))
    wu, _ = mesh.weight(p["w_up"], ("moe", "w_up"), (E, d, ff))
    wd, _ = mesh.weight(p["w_down"], ("moe", "w_down"), (E, ff, d))
    blk = _token_block(S, M, r)
    xb = x[:, blk]
    Sl = xb.shape[1]
    forced = None
    if moe_apply.replay is not None:    # whole-batch ids: take our tokens'
        ids = moe_apply.replay.pop(0)
        Bg = ids.shape[0] // S
        ids = ids.view(Bg, S, -1)
        if ctx.batch_sharded(Bg):
            ids = ids[ctx.block(Bg, ctx.dp_axes)]
        forced = ids[:, blk].reshape(-1, ids.shape[-1]).to(x.device)
    s = _send(xb.reshape(-1, d), p["router"], cfg, M, forced)
    cap, cap_exp = capacities(B * Sl, cfg, M)
    recv_x = compat.all_to_all_axis(s["send_x"], ctx, tp)
    recv_le = compat.all_to_all_axis(s["send_le"], ctx, tp)
    back, done = _experts(recv_x.reshape(-1, d), recv_le.reshape(-1), wg, wu,
                          wd, cap_exp)
    back = compat.all_to_all_axis(back.view(M, cap, d), ctx, tp)
    y, _ = _combine(back.reshape(-1, d), s, x.dtype)
    y = y.view(B, Sl, d)
    if Sl != S:
        y = compat.all_gather_axis(y, ctx, tp, dim=1)
    me = compat.pmean_axis(s["me"], ctx, tp)
    ce = compat.pmean_axis(s["ce"], ctx, tp)
    aux = compat.pmean_axis(_aux(cfg, me, ce), ctx, ctx.fsdp_axis)
    for axis in ctx.dp_axes:
        if axis != ctx.fsdp_axis:
            aux = compat.pmean_axis(aux, ctx, axis)
    if moe_apply.record is not None:
        le = recv_le.reshape(-1)
        sent = int((s["send_le"] < E // M).sum())
        dropped = s["expert_id"].numel() - sent + int(
            ((le < E // M) & ~done).sum())
        moe_apply.record.append({"tokens": B * Sl, "x": x, "y": y,
                                 "expert_id": s["expert_id"],
                                 "own_id": s["own_id"],
                                 "margin": route_margin(s["logits"],
                                                        cfg.top_k),
                                 "dropped": dropped})
    if "shared" in p:
        y = y + mesh.ffn(p["shared"], x, "shared",
                         cfg.n_shared_experts * cfg.d_ff)
    return y, aux


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """x [B, S, d] -> (y [B, S, d], aux f32 scalar). ``p`` holds one
    layer: router ``[d, E]``, ``w_gate``/``w_up`` ``[E, d, ff]``,
    ``w_down`` ``[E, ff, d]``, optionally ``shared``; on a mesh
    (``mesh``, the forward's ``layers.MeshWeights``) the rank's blocks
    of them, and x the rank's residual block (``_moe_mesh``; its
    ``record`` entries hold the rank's ``x`` and ``y``, before the
    shared expert)."""
    if mesh is not None:
        return _moe_mesh(p, x, cfg, mesh)
    B, S, d = x.shape
    forced = moe_apply.replay.pop(0) if moe_apply.replay is not None \
        else None
    y, aux, expert_id, kept, (own_id, logits) = _dispatch(
        x.reshape(B * S, d), p, cfg, forced)
    if moe_apply.record is not None:
        moe_apply.record.append({"tokens": B * S, "expert_id": expert_id,
                                 "kept": kept,
                                 "dropped": int((~kept).sum()),
                                 "own_id": own_id,
                                 "margin": route_margin(logits, cfg.top_k)})
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + L.ffn_apply(p["shared"], x)
    return y, aux


moe_apply.record = None
moe_apply.replay = None
