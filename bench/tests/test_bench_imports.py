"""Nothing the benchmark runs imports JAX, its libraries or the JAX
package (compared by whole top-level name: ``repro_torch`` begins with
``repro`` and is the program), and the plain reference imports nothing of
the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH_DIR = harness.ROOT / "bench"
PROGRAM = {"repro_torch"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH_DIR).as_posix() for p in BENCH_DIR.rglob("*.py")))
def test_no_file_of_the_benchmark_names_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(BENCH_DIR / path)}
    assert not tops & set(harness.FORBIDDEN), tops
    if path.startswith("reference/"):
        assert not tops & PROGRAM, f"the reference imports {tops & PROGRAM}"


def test_forbidden_modules_compares_whole_top_level_names():
    ok = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping", "torch"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["jax.numpy", "repro.models"]) \
        == ["jax", "repro"]


RUN_ALL = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from bench import harness
from bench.tests import tiny
for name in ("embed", "prefill"):
    __import__("bench.drivers." + name)
for m in tiny.BENCH["per_layer"]:
    harness.load_reader(m["name"])
import bench.calibrate, bench.run
for cell in ("recall.embed", "qwen2.prefill_2k"):
    tiny.measure(cell, seconds=0.1, trace=True)
print("LOADED", harness.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = RUN_ALL.format(root=str(harness.ROOT),
                          src=str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
