"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

``repro_torch`` imports torch and numpy only; only the parity tests import
both packages.  Its entry points run on CUDA unless the caller asks for
the CPU.
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


@pytest.mark.parametrize("path", sorted(p.relative_to(PORT).as_posix()
                                        for p in PORT.rglob("*")
                                        if p.suffix in (".py", ".cu", ".cuh")))
def test_no_source_names_jax_or_the_jax_package(path):
    text = (PORT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
    assert not re.search(r"\brepro\.", text), path


def test_load_defaults_to_cuda_and_never_falls_back_to_cpu():
    from repro_torch import api
    if torch.cuda.is_available():
        assert api.load("qwen2.5-14b", smoke=True).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load("qwen2.5-14b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load("qwen2.5-14b", smoke=True, device="cuda")
    assert api.load("qwen2.5-14b", smoke=True,
                    device="cpu").device.type == "cpu"
