"""Build the port's CUDA kernels from ``csrc/`` at first use, bind with ctypes.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface
(pointers, ints and a ``cudaStream_t``; every launch function returns
``cudaGetLastError()``). ``nvcc`` compiles it for ``sm_90a`` into
``build/kernels/`` at the repo root, under a name that carries a hash of
the sources and flags, so an edited source is rebuilt and a built one is
reused. ``build`` starts one ``nvcc`` per source, all at once.

Flags: no ``--use_fast_math`` and ``-fmad=false``, so division, square
root and every multiply-add round as IEEE float32 does on the host, which
the bit-identity of the backends needs (DESIGN.md §12.1).
``flash_attention.cu`` (``SPLIT_COMPILE``) also takes
``--split-compile=0``, which optimizes its 38 kernel instances on as
many threads as the host has cores: 22 s against 53 s without it, the
same registers and kernel times. The other sources build without it, as
they always have (it changes their machine code).

Nothing here runs at import: the CPU has no ``nvcc`` and needs none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("sparse_match", "sparse_match_packed", "fused",
           "flash_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# sources whose many kernel instances are optimized on every core
SPLIT_COMPILE = ("flash_attention",)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def flags(name: str) -> tuple:
    """nvcc's flags for source ``name``."""
    return NVCC_FLAGS + (("--split-compile=0",) if name in SPLIT_COMPILE
                         else ())


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source not built yet, one ``nvcc`` each, in
    parallel. Returns ``{name: {"seconds", "log"}}`` for the ones built
    (``log`` holds ptxas' register and spill report, also written beside
    the library, ``ptxas_log``); raises with the compiler's output if any
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report, failed = {}, []
    for name, (out, tmp, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".ptxas").write_text(log)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def ptxas_log(name: str) -> str:
    """ptxas' register and spill report of library ``name`` (``-v``), kept
    beside the library when it is built; builds it if the report is
    missing."""
    log = library_path(name).with_suffix(".ptxas")
    if not log.exists():
        library_path(name).unlink(missing_ok=True)
        build([name])
    return log.read_text()


def kernel(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``name``, built if needed,
    with its ``argtypes`` set and an ``int`` (cudaError_t) result."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.rsm_error_string.argtypes = [ctypes.c_int]
            lib.rsm_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def count_launch(wrapper, design: Optional[str] = None,
                 *also: Optional[str]) -> None:
    """Add one to ``wrapper.launches`` (and to
    ``wrapper.launches_by_design[design]``, and to each integer attribute
    that ``also`` names; ``None`` names none) under a lock. Several
    threads launch at once (the cluster router's shard pool, prefetch
    loaders, hedge attempts), and a bare ``+= 1`` on an attribute can lose
    a count between its read and its write. Setting ``wrapper.launches =
    0`` resets the count."""
    with _count_lock:
        wrapper.launches += 1
        if design is not None:
            wrapper.launches_by_design[design] += 1
        for name in also:
            if name is not None:
                setattr(wrapper, name, getattr(wrapper, name) + 1)


def check(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err:
        msg = _libs[name].rsm_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
