"""Where a training step's time goes in the PyTorch/CUDA port, on one card.

    PYTHONPATH=src python benchmarks/port_train_profile.py \
        [--arch qwen3-4b] [--layers N] [--batch 4] [--seq-len 1024] \
        [--int8-opt] [--json]

Builds the model at full width from seed 0 on the card (full depth, or
its first ``--layers N``), f32 or int8 AdamW states, remat ``minimal``,
and the batches of ``SyntheticLMData``; runs ``make_train_step``'s step
once to warm up, then:

  - two steps on the host clock, each ending with the card synchronized;
  - the step's parts by CUDA events: forward and backward (``loss_fn``
    and ``torch.autograd.grad``), the optimizer (``apply_updates``);
  - the attention at one layer's shape by CUDA events: B4 forward with
    its lse (which a step runs twice a layer: the forward and remat's
    recompute), the plain backward (``layers.attention_bwd``, once a
    layer), and SDPA's backward as a yardstick;
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
from repro_torch.models import layers, model as M
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
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, cfg.dtype)) for shape in (
            (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    o, lse = fa.flash_attention_gqa(q, k, v, return_lse=True)
    out["b4_lse_ms"] = events_ms(
        lambda: fa.flash_attention_gqa(q, k, v, return_lse=True), 20)
    out["attention_bwd_ms"] = events_ms(
        lambda: layers.attention_bwd(q, k, v, o, lse, dout), 5)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    out["sdpa_bwd_ms"] = events_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), 20)
    del q, k, v, dout, o, lse, qt, kt, vt, ot

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
    print(f"card: {out['card']}")
    print(f"{cfg.name} ({n} layers, {out['params']} params, batch {B} x "
          f"{S}, {'int8' if args.int8_opt else 'f32'} states): step "
          f"{out['step_ms']:.1f} ms on the host clock (median of 2); "
          f"forward + backward {out['fwd_bwd_ms']:.1f} ms, optimizer "
          f"{out['optimizer_ms']:.1f} ms (CUDA events)")
    print(f"attention a layer: B4 with lse {out['b4_lse_ms']:.4f} ms (x "
          f"{2 * n} a step: {2 * n * out['b4_lse_ms']:.1f} ms); plain "
          f"backward {out['attention_bwd_ms']:.3f} ms (x {n}: "
          f"{n * out['attention_bwd_ms']:.1f} ms); SDPA's backward "
          f"{out['sdpa_bwd_ms']:.4f} ms as a yardstick")
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
