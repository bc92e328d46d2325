"""What the benchmark may load and read: no JAX and no JAX package
(top-level names compared whole), a reference that imports nothing of the
program, and an entry point that refuses to run without a card or
without the program."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench.core.cell import BANNED, banned_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def imports(path: Path):
    """Top-level names a source imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_banned_names_compare_whole():
    fake = ["repro_torch_like", "reprox", "jax_shim", "flaxen",
            "repro.fake_mod", "jaxlib.fake_mod"]
    for n in fake:
        sys.modules[n] = type(sys)(n)
    try:
        found = banned_modules()
        assert "repro.fake_mod" in found and "jaxlib.fake_mod" in found
        assert not {"repro_torch_like", "reprox", "jax_shim",
                    "flaxen"} & set(found)
        assert not any(n.split(".")[0] == "repro_torch" for n in found)
    finally:
        for n in fake:
            del sys.modules[n]


def test_sources_import_no_jax_side_module():
    for path in BENCH.rglob("*.py"):
        assert not imports(path) & set(BANNED), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = imports(path)
        assert "repro_torch" not in names, path
        assert names <= {"torch", "math", "typing", "__future__", "bench",
                         "numpy"}, (path, names)
        text = path.read_text()
        assert "bench.core" not in text and "repro_torch" not in \
            text.replace("of ``repro_torch``", ""), path


def test_nothing_reads_the_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        for name in ("BENCH_serving", "chip_smoke", "benchmarks/",
                     "benchmarks."):
            assert name not in text, (path, name)


def run_py(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen14b-chat",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = run_py(ROOT)
    assert r.returncode == 3 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
    names = json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]
    assert names == ["bench"]
