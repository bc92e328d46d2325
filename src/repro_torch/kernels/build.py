"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout; the hash covers the source and the shared headers, so an edited
source rebuilds and an unchanged one loads the library already built.
Libraries load with ``ctypes`` (no PyTorch headers in the build, which
keeps each build to seconds).  Nothing here runs at import time: the first
CUDA launch of a kernel builds it, and ``build_all`` builds every source
at once, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: build directory at the checkout root (``src/repro_torch/..`` / ``..``);
#: ``.gitignore`` lists ``build/``
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: every kernel source of the package (one shared library each)
SOURCES = ("paged_attention", "paged_prefill", "paged_ring_prefill",
           "flash_attention", "paged_mla", "paged_mla_prefill", "lru_scan",
           "wkv6", "moe_grouped")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME`` (default ``/usr/local/cuda``) or PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of repro_torch build from source on first CUDA use")
    return found


def lib_path(name: str) -> Path:
    """The library file of ``csrc/<name>.cu`` for the current sources."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, subprocess.Popen]:
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)            # atomic: a concurrent loader sees all or none
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every named source that has no up-to-date library, one
    ``nvcc`` per source, all running at once.  Returns name -> compiler
    log (``-Xptxas -v`` register and shared-memory report; empty for a
    library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {n: _start(n) for n in names if not lib_path(n).exists()}
    logs = {n: "" for n in names}
    for n, (out, proc) in started.items():
        logs[n] = _finish(n, out, proc)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
