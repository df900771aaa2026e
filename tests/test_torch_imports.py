"""The port stands alone: no file under src/repro_torch/, and not
chip_smoke.py or the port's examples, imports jax or the JAX package
(repro)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "train_recall_mem_torch.py",
    ROOT / "examples" / "edge_simulation_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "serve_retrieval_torch.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_files():
    assert len(FILES) > 20 and all(f.exists() for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path} imports {bad}"
