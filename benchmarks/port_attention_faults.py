"""How far the checks of flash attention (B4) see: plant a fault in the
kernel's wgmma instance and read what ``chip_smoke.py``'s checks read.

    PYTHONPATH=src python benchmarks/port_attention_faults.py \
        [--arch qwen2-0.5b] [--json]

For each fault in ``FAULTS`` it writes an edited copy of
``kernels/csrc/flash_attention.cu`` to ``build/faults/`` (the sources
stay as they are), builds the copies with the port's flags, one nvcc
each, in parallel, and loads each in turn in place of the built library.
For the unchanged kernel and each fault it prints, at the arch's
prefill shape (qwen2-0.5b: q [4, 1024, 14, 64], k, v [4, 1024, 2, 64];
zamba2-1.2b: 32 heads over 32; musicgen-medium: 24 over 24, 48 layers
on tokens; bf16, causal, ``chip_smoke``'s seeded
inputs), the max |kernel - plain| of B4 (against ``ATTN_TOL``, as atol
and rtol), its row-scaled error (against ``ATTN_ROW_TOL``), and the max
|logit| difference of the full-width, full-depth bf16 model's
last-position prefill logits with the kernel against plain attention,
seed 0 weights and prompts (against ``chip_smoke.lm_atol``: LM_ULPS
ulps, ZAMBA_ULPS for the hybrid). One more row reads the model's own
response to rounding: plain attention with its bf16 outputs moved one
ulp up or down at the rate the unchanged kernel's differ from plain's
at this shape. Needs a card and nvcc.
"""
import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its tolerances and seeded inputs)

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, flash_attention as fa  # noqa: E402
from repro_torch.models import layers, model as M  # noqa: E402
from repro_torch.serve import step  # noqa: E402

# name -> (a line of the wgmma instance, what it becomes)
FAULTS = {
    "skip key tile 1 for query tiles from row 512": (
        "    // s = q kᵀ: [64, HD] x [HD, 64], HD / 16 steps of K 16 (each",
        "    if (t == 1 && q0 >= 512) continue;\n"
        "    // s = q kᵀ: [64, HD] x [HD, 64], HD / 16 steps of K 16 (each"),
    "row sum counts key tile 0 twice for query tiles from row 512": (
        "      l[j] = l[j] * alpha[j] + ps[j];\n",
        "      l[j] = l[j] * alpha[j]"
        " + ps[j] * (t == 0 && q0 >= 512 ? 2 : 1);\n"),
    "causal mask one key late": (
        "          if (col >= Sk || (causal && col > row) ||",
        "          if (col >= Sk || (causal && col > row + 1) ||"),
}


def build_faults(out_dir: Path) -> dict:
    """{fault: path of its built library}; raises if an edit misses."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(FAULTS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: its line is not in the "
                               "source once")
        cu = out_dir / f"fault{i}.cu"
        cu.write_text(src.replace(old, new))
        lib = out_dir / f"fault{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.flags("flash_attention"),
             f"-I{_build.CSRC}", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for fault {name!r}:\n{log}")
    return {name: lib for name, (lib, _) in procs.items()}


@contextlib.contextmanager
def loaded(path):
    """The flash_attention library at ``path`` in place of the built one
    (``None``: the built one)."""
    fa_lib = "flash_attention"
    _build.kernel(fa_lib, *fa._SYMBOLS["wgmma"])      # the built one, loaded
    saved = _build._libs[fa_lib]
    if path is not None:
        lib = ctypes.CDLL(str(path))
        lib.rsm_error_string.argtypes = [ctypes.c_int]
        lib.rsm_error_string.restype = ctypes.c_char_p
        _build._libs[fa_lib] = lib
    try:
        yield
    finally:
        _build._libs[fa_lib] = saved


def ulp_noise(rate, seed=1):
    """Plain attention whose bf16 outputs each move one ulp, up or down
    at even odds, with probability ``rate``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def attn(q, k, v, **kw):
        out = fa.flash_attention_gqa_plain(q, k, v, **kw)
        hit = torch.rand(out.shape, generator=gen, device=out.device) < rate
        up = torch.rand(out.shape, generator=gen, device=out.device) < 0.5
        step_ = torch.where(up, 1, -1).to(torch.int16)
        bits = out.view(torch.int16)
        bits[hit] += step_[hit]
        return out
    return attn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=[chip_smoke.LM_ARCH,
                                       chip_smoke.ZAMBA_ARCH,
                                       chip_smoke.MUSICGEN_ARCH],
                    default=chip_smoke.LM_ARCH)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.nvidia_smi_line()}")
    _build.build(["flash_attention"])
    libs = {"none": None, **build_faults(_build.BUILD_DIR.parent / "faults")}

    cfg = get_config(args.arch)
    B, S = chip_smoke.LM_BATCH, chip_smoke.LM_PROMPT
    q, k, v = chip_smoke.attention_inputs(torch, dev, B, S, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.head_dim,
                                          torch.bfloat16)
    want = fa.flash_attention_gqa_plain(q, k, v)
    params = M.init(cfg, seed=chip_smoke.SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(chip_smoke.SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=dev)
    prefill = step.make_prefill(cfg)
    kernel_attn = layers.flash_attention_gqa
    layers.flash_attention_gqa = fa.flash_attention_gqa_plain
    try:
        logits_plain = prefill(params, {"tokens": prompt})[0].float()
    finally:
        layers.flash_attention_gqa = kernel_attn

    ulps = chip_smoke.ZAMBA_ULPS if cfg.family == "hybrid" \
        else chip_smoke.LM_ULPS
    limits = {"max_abs_err": chip_smoke.ATTN_TOL["bfloat16"],
              "row_scaled_err": chip_smoke.ATTN_ROW_TOL,
              "lm_logit_err": chip_smoke.lm_atol("bfloat16", logits_plain,
                                                 ulps)}
    with loaded(None):
        rate = float((fa.flash_attention_gqa(q, k, v) != want).float()
                     .mean())
    print(f"{cfg.name}: the unchanged kernel's bf16 outputs differ from "
          f"plain in {rate:.3e} of the entries")
    runs = [(name, path, None) for name, path in libs.items()]
    runs.append(("plain, one-ulp flips at the kernel's rate", None,
                 ulp_noise(rate)))
    rows = []
    for name, path, attn in runs:
        with loaded(path):
            if attn is None:
                got = fa.flash_attention_gqa(q, k, v)
                logits = prefill(params, {"tokens": prompt})[0].float()
            else:
                got = attn(q, k, v)
                layers.flash_attention_gqa = attn
                try:
                    logits = prefill(params, {"tokens": prompt})[0].float()
                finally:
                    layers.flash_attention_gqa = kernel_attn
            torch.cuda.synchronize()
        row = {"fault": name,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "row_scaled_err": chip_smoke.row_scaled_err(got, want),
               "lm_logit_err": float((logits - logits_plain).abs().max())}
        # ATTN_TOL as chip_smoke applies it: atol and rtol both
        tol = limits["max_abs_err"]
        row["caught_by"] = [key for key, lim in limits.items()
                            if key != "max_abs_err" and row[key] > lim]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            row["caught_by"].insert(0, "max_abs_err")
        rows.append(row)
        print(f"{name}: B4 max_abs_err {row['max_abs_err']:.4e} (limit "
              f"{limits['max_abs_err']}), row-scaled "
              f"{row['row_scaled_err']:.4e} (limit "
              f"{limits['row_scaled_err']}); bf16 model logits "
              f"{row['lm_logit_err']:.4e} (limit {limits['lm_logit_err']});"
              f" caught by {row['caught_by'] or 'none'}")
    if args.json:
        print(json.dumps({"arch": cfg.name, "flip_rate": rate,
                          "limits": limits, "rows": rows}))


if __name__ == "__main__":
    main()
