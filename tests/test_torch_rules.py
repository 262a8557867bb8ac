"""Rules of the port that no differential test would catch:

  - ``src/repro_torch``, ``chip_smoke.py`` and the port's examples and
    benchmarks (``examples/port_*.py``, ``benchmarks/port_*.py``) import
    neither ``jax`` nor the JAX package ``repro`` (only ``repro_torch``);
  - with no CUDA card, the default device is an error, never the CPU
    (the search engine, the store session, the cluster session and its
    router, the serving launcher, and the LM's init, generate and
    launcher);
  - a wrapper given CUDA tensors launches its kernel or raises: it never
    reaches its plain version (checked with fake CUDA tensors and a
    kernel loader that raises);
  - the default backend is the ELL kernel, ``gpu``.
"""
import ast
import inspect
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import device as device_mod
from repro_torch.configs.paper_search import smoke
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.configs import qwen2_0p5b
from repro_torch.kernels import _build, flash_attention, fused, ops
from repro_torch.kernels import sparse_match, sparse_match_packed
from repro_torch.launch import search as launcher
from repro_torch.launch import search_serve
from repro_torch.launch import serve as lm_launcher
from repro_torch.models import model as lm_model
from repro_torch.serve import step as lm_step

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("port_*.py"))
              + sorted((ROOT / "benchmarks").glob("port_*.py"))
              + [ROOT / "chip_smoke.py"])


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve("cuda")
    assert device_mod.resolve("cpu") == torch.device("cpu")


def test_engine_without_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PatternSearchEngine(None, smoke())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--n-docs", "4", "--vocab", "64"])


def test_serving_launcher_without_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_serve.main(["--n-docs", "4", "--vocab", "64"])


def test_store_session_without_device_raises_without_a_card(no_card,
                                                           tmp_path):
    from repro_torch.storage import FlashSearchSession, FlashStore
    store = FlashStore.create(str(tmp_path / "s"), vocab_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlashSearchSession(store, smoke())
    FlashSearchSession(store, smoke(), device="cpu").close()


def test_cluster_without_device_raises_without_a_card(no_card, tmp_path):
    from repro_torch.cluster import (FlashClusterSession, ShardRouter,
                                     build_sharded_store)
    cl = build_sharded_store(str(tmp_path / "c"), [(0, [(1, 2)])],
                             n_shards=2, replicas=2, vocab_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlashClusterSession(cl, smoke())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardRouter(cl, smoke())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_serve.main(["--cluster", cl.root, "--vocab", "64"])
    sess = FlashClusterSession(cl, smoke(), device="cpu")
    assert sess.router.device == torch.device("cpu")
    sess.close()


def test_lm_entry_points_without_device_raise_without_a_card(no_card):
    cfg = qwen2_0p5b.smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_model.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_model.init_cache(cfg, 1, 4)
    params = lm_model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_step.generate(params, cfg, [[1, 2]], max_new=2, max_len=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_launcher.main(["--arch", "qwen2-0.5b", "--smoke"])


def test_default_backend_is_the_ell_kernel():
    sig = inspect.signature(PatternSearchEngine.__init__)
    assert sig.parameters["backend"].default == "gpu"
    assert sig.parameters["device"].default is None
    assert inspect.signature(ops.correlate).parameters[
        "backend"].default == "gpu"
    from repro_torch.cluster import FlashClusterSession, ShardRouter
    for cls in (FlashClusterSession, ShardRouter):
        params = inspect.signature(cls.__init__).parameters
        assert params["backend"].default == "gpu"
        assert params["device"].default is None


def _cuda_calls():
    """One call per wrapper, on fake CUDA tensors of valid shapes."""
    i32, f32 = torch.int32, torch.float32
    q_ids = torch.zeros(8, dtype=i32, device="cuda")
    q_vals = torch.zeros(8, 2, dtype=f32, device="cuda")
    return {
        "sparse_match": lambda: sparse_match.sparse_match(
            torch.zeros(4, 3, dtype=i32, device="cuda"),
            torch.zeros(4, 3, dtype=f32, device="cuda"), q_ids, q_vals),
        "sparse_match_packed": lambda: sparse_match_packed.sparse_match_packed(
            torch.zeros(4, 3, dtype=i32, device="cuda"), q_ids, q_vals),
        "fused": lambda: fused.fused_match_topk(
            torch.zeros(2, 12, dtype=i32, device="cuda"), q_ids, q_vals,
            torch.ones(2, dtype=f32, device="cuda"), block_docs=4, kp=2),
        "flash_attention": lambda: flash_attention.flash_attention(
            *(torch.zeros(2, 8, 16, device="cuda") for _ in range(3))),
        "flash_attention_gqa": lambda: flash_attention.flash_attention_gqa(
            torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device="cuda"),
            *(torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device="cuda")
              for _ in range(2))),
    }


@pytest.mark.parametrize("name", ["sparse_match", "sparse_match_packed",
                                  "fused", "flash_attention",
                                  "flash_attention_gqa"])
def test_cuda_tensors_never_reach_the_plain_version(monkeypatch, name):
    def loader_fails(*args, **kwargs):
        raise RuntimeError("kernel loader called")

    def plain_called(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(_build, "kernel", loader_fails)
    monkeypatch.setattr(sparse_match, "sparse_match_plain", plain_called)
    monkeypatch.setattr(sparse_match_packed, "sparse_match_packed_plain",
                        plain_called)
    monkeypatch.setattr(fused, "fused_match_topk_plain", plain_called)
    monkeypatch.setattr(flash_attention, "flash_attention_gqa_plain",
                        plain_called)
    with FakeTensorMode():
        call = _cuda_calls()[name]
        with pytest.raises(RuntimeError, match="kernel loader called"):
            call()


def test_mixed_devices_are_refused():
    with FakeTensorMode():
        q_ids = torch.zeros(8, dtype=torch.int32, device="cuda")
        q_vals = torch.zeros(8, 2, device="cuda")
        with pytest.raises(ValueError, match="one CUDA device"):
            sparse_match.sparse_match(
                torch.zeros(4, 3, dtype=torch.int32),
                torch.zeros(4, 3), q_ids, q_vals)


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_gqa"])
def test_mixed_devices_are_refused_by_flash_attention(entry):
    with FakeTensorMode():
        kv = torch.zeros(1, 8, 2, 16, device="cuda")
        bh = torch.zeros(2, 8, 16, device="cuda")
        call = {"flash_attention": lambda: flash_attention.flash_attention(
                    torch.zeros(2, 8, 16), bh, bh),
                "flash_attention_gqa": lambda: (
                    flash_attention.flash_attention_gqa(
                        torch.zeros(1, 8, 4, 16), kv, kv))}[entry]
        with pytest.raises(ValueError, match="one CUDA device"):
            call()
