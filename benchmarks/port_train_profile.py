"""Where a training step's time goes in the PyTorch/CUDA port, on one card.

    PYTHONPATH=src python benchmarks/port_train_profile.py \
        [--arch qwen3-4b] [--layers N] [--batch 4] [--seq-len 1024] \
        [--int8-opt] [--json]

(``--arch rwkv6-7b --int8-opt``: its f32 states do not fit 80 GB;
``--arch zamba2-1.2b``.)

Builds the model at full width from seed 0 on the card (full depth, or
its first ``--layers N``), f32 or int8 AdamW states, remat ``minimal``,
and the batches of ``SyntheticLMData``; runs ``make_train_step``'s step
once to warm up, then:

  - two steps on the host clock, each ending with the card synchronized;
  - the step's parts by CUDA events: forward and backward (``loss_fn``
    and ``torch.autograd.grad``), the optimizer (``apply_updates``);
  - the attention at one layer's shape by CUDA events: B4 forward with
    its lse (which a step runs twice a layer: the forward and remat's
    recompute; once a site for zamba2, whose shared block is not
    rematerialized; never for rwkv6), the plain backward
    (``layers.attention_bwd``, once a layer or site), and SDPA's backward
    as a yardstick;
  - for the recurrent archs, the scan at layer 0's shape on its own
    inputs (the embedded batch, the layer's params) by CUDA events: its
    forward (no grad; a step runs it twice a layer, the forward and
    remat's recompute) and its backward (rwkv6: ``WKVChunked``'s, which
    recomputes each group; zamba2: plain autograd through the SSD scan);
    and one layer's forward and backward with autograd, as remat's
    recompute runs it: the bytes it saves (params aside) and its peak
    over what was allocated before it;
  - the cross-entropy's forward and backward at the logits' shape;
  - one step under ``torch.profiler``: device time by kernel (the top
    ones) and the card's idle share of the step's wall time (profiler
    on).

Prints the card's name and power limit beside every number. Needs a
card; it does not run on the CPU.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import hybrid, layers, mamba2, model as M, rwkv6
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step


def events_ms(fn, reps=1, warm=True):
    """Median device time of ``fn`` by CUDA events, after one warm-up
    call where ``warm``."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_parts(cfg, B, S, gen, dev):
    """B4 with its lse, the plain backward and SDPA's backward at one
    layer's (or site's) shape, by CUDA events."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, cfg.dtype)) for shape in (
            (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    o, lse = fa.flash_attention_gqa(q, k, v, return_lse=True)
    out = {"b4_lse_ms": events_ms(
        lambda: fa.flash_attention_gqa(q, k, v, return_lse=True), 20),
        "attention_bwd_ms": events_ms(
            lambda: layers.attention_bwd(q, k, v, o, lse, dout), 5)}
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    out["sdpa_bwd_ms"] = events_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), 20)
    return out


def scan_parts(cfg, params, tokens, gen, dev):
    """The recurrent scan at layer 0 on its own inputs: forward (no grad)
    and backward ms by CUDA events; one layer's saved bytes and peak
    under autograd."""
    mod, blocks, scan = ((rwkv6, params["blocks"], "_wkv_chunked")
                         if cfg.family == "ssm" else
                         (mamba2, params["mamba"], "_ssd_chunked"))
    pb = blocks[0]
    B = tokens.shape[0]
    with torch.no_grad():
        x = layers.embed_apply(params["embed"], tokens)
    state = ({k: t[0] for k, t in rwkv6.init_state(cfg, B, x.dtype,
                                                   dev).items()}
             if cfg.family == "ssm" else
             {k: t[0] for k, t in mamba2.init_state(cfg, 1, B, x.dtype,
                                                    dev).items()})
    grabbed = []
    real = getattr(mod, scan)
    setattr(mod, scan, lambda *a: grabbed.append(a) or real(*a))
    try:
        with torch.no_grad():
            mod.block_apply(pb, x, cfg, state)
    finally:
        setattr(mod, scan, real)
    args = grabbed[0]
    n_in = 5                # the inputs before the state, then chunk

    def fwd():
        with torch.no_grad():
            real(*args)

    leaves = [t.detach().requires_grad_(True) for t in args[:n_in]]
    ys = real(*leaves, *args[n_in:])
    cots = [torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
            for y in ys]
    del ys

    def fwd_bwd():
        torch.autograd.grad(real(*leaves, *args[n_in:]), leaves, cots)

    out = {"scan_fwd_ms": events_ms(fwd, 3)}
    out["scan_bwd_ms"] = events_ms(fwd_bwd, 3) - out["scan_fwd_ms"]
    del leaves, cots, grabbed

    # one layer with autograd, as remat's recompute runs it
    held = {p.untyped_storage().data_ptr() for _, p in opt.flatten(params)}
    saved = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in held:
            saved[ptr] = t.untyped_storage().nbytes()
        return t

    xl = x.detach().requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = mod.block_apply(pb, xl, cfg, state)[0]
    torch.autograd.grad(y, [xl] + [p for _, p in opt.flatten(pb)],
                        torch.ones_like(y))
    torch.cuda.synchronize()
    out["layer_saved_gb"] = sum(saved.values()) / 1e9
    out["layer_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    B, S = args.batch, args.seq_len
    tc = TrainConfig(model=cfg, opt=OptimizerConfig(
        lr=3e-4, warmup_steps=0, total_steps=10, int8_states=args.int8_opt),
        seq_len=S, global_batch=B)
    params = M.init(cfg, seed=0, device=dev)
    leaves = [p.requires_grad_(True) for _, p in opt.flatten(params)]
    state = opt.init_state(tc.opt, params)
    step = make_train_step(tc, cfg)
    data = SyntheticLMData(cfg, B, S, seed=0)
    batches = [to_device(data.batch_at(i), dev) for i in range(4)]
    out = {"card": card(), "arch": cfg.name, "layers": cfg.n_layers,
           "batch": B, "seq_len": S, "int8_states": args.int8_opt,
           "params": sum(p.numel() for p in leaves)}

    step(params, state, batches[0])                       # warm-up
    torch.cuda.synchronize()
    host = []
    for b in batches[1:3]:
        t0 = time.perf_counter()
        _, _, metrics = step(params, state, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = statistics.median(host)

    # the step's parts
    held = {}

    def fwd_bwd():
        loss, _ = M.loss_fn(params, cfg, batches[3])
        held["grads"] = torch.autograd.grad(loss, leaves)
    # no warm-up call (the steps were): two sets of grads would not fit
    out["fwd_bwd_ms"] = events_ms(fwd_bwd, warm=False)
    grads = opt.unflatten(params, held.pop("grads"))
    out["optimizer_ms"] = events_ms(
        lambda: opt.apply_updates(tc.opt, params, grads, state))
    del grads

    # attention at one layer's shape
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.family != "ssm":
        out.update(attention_parts(cfg, B, S, gen, dev))
    if cfg.family in ("ssm", "hybrid"):
        out.update(scan_parts(cfg, params, batches[3]["tokens"], gen, dev))

    # the cross-entropy at the logits' shape
    logits = torch.randn((B, S - 1, cfg.vocab_size), generator=gen,
                         device=dev).to(getattr(torch, cfg.dtype))
    logits.requires_grad_(True)
    labels = batches[3]["tokens"][:, 1:]
    mask = torch.ones(labels.shape, device=dev)
    out["cross_entropy_ms"] = events_ms(lambda: torch.autograd.grad(
        layers.softmax_cross_entropy(logits, labels, mask), logits))
    del logits
    torch.cuda.empty_cache()

    # one step under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step(params, state, batches[1])
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    table = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0:
            table[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy = sum(ms for ms, _ in table.values())
    out.update(profiled_step_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               kernels=dict(sorted(table.items(), key=lambda kv: -kv[1][0])[
                   :25]))
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9

    if args.json:
        print(json.dumps(out))
        return out
    n = cfg.n_layers
    # B4 launches and attention backwards a step: zamba2's shared block
    # runs once a site (not rematerialized), a transformer layer's B4
    # twice (the forward and remat's recompute)
    a_calls = ((hybrid.n_attn_sites(cfg),) * 2 if cfg.family == "hybrid"
               else (2 * n, n))
    print(f"card: {out['card']}")
    print(f"{cfg.name} ({n} layers, {out['params']} params, batch {B} x "
          f"{S}, {'int8' if args.int8_opt else 'f32'} states): step "
          f"{out['step_ms']:.1f} ms on the host clock (median of 2); "
          f"forward + backward {out['fwd_bwd_ms']:.1f} ms, optimizer "
          f"{out['optimizer_ms']:.1f} ms (CUDA events)")
    if "b4_lse_ms" in out:
        f, b = a_calls
        print(f"attention a layer: B4 with lse {out['b4_lse_ms']:.4f} ms (x "
              f"{f} a step: {f * out['b4_lse_ms']:.1f} ms); plain "
              f"backward {out['attention_bwd_ms']:.3f} ms (x {b}: "
              f"{b * out['attention_bwd_ms']:.1f} ms); SDPA's backward "
              f"{out['sdpa_bwd_ms']:.4f} ms as a yardstick")
    if "scan_fwd_ms" in out:
        print(f"scan at layer 0: forward {out['scan_fwd_ms']:.2f} ms (x "
              f"{2 * n} a step: {2 * n * out['scan_fwd_ms']:.1f} ms), "
              f"backward {out['scan_bwd_ms']:.2f} ms (x {n}: "
              f"{n * out['scan_bwd_ms']:.1f} ms); one layer under autograd "
              f"saves {out['layer_saved_gb']:.3f} GB (params aside) and "
              f"peaks at {out['layer_peak_gb']:.3f} GB over what was "
              "allocated before it")
    print(f"cross-entropy forward + backward at [{B}, {S - 1}, "
          f"{cfg.vocab_size}]: {out['cross_entropy_ms']:.2f} ms")
    print(f"profiled step: {wall:.1f} ms wall, device busy {busy:.1f} ms, "
          f"idle share {out['idle_share']:.3f}; max_memory_allocated "
          f"{out['max_memory_allocated_gb']:.2f} GB")
    for name, (ms, count) in out["kernels"].items():
        print(f"  {ms:9.2f} ms  {count:6d}x  {name[:110]}")
    return out


if __name__ == "__main__":
    main()
