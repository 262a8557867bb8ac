"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(HERE.rglob("*.py"))


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not top_names(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = top_names(HERE / "reference.py")
    assert names <= {"__future__", "typing", "numpy", "torch"}, names


def _loaded(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys; print(' '.join(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_what_a_run_loads():
    code = ("from searchbench import harness\n"
            "import repro_torch.serve, repro_torch.core.engine\n"
            "from repro_torch.kernels import _build, fused\n"
            "for m in harness.read_json(harness.ROOT / 'BENCHMARK.json')"
            "['per_layer']: harness.reader(m['name'])")
    mods = _loaded(code)
    assert "repro_torch" in mods and not mods & FORBIDDEN


def test_the_reference_alone():
    mods = _loaded("from searchbench import reference")
    assert not mods & (FORBIDDEN | {"repro_torch"})
