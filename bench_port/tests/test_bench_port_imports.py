"""No module under bench_port/ imports JAX or the JAX package, compared by
the whole top-level name, and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "rtvm_tpu", "chip_smoke", "tools", "bench"}


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_names(path)
    assert "rtvm_tpu_torch" not in names and "bench_port" not in names


def test_the_check_compares_whole_names(tmp_path):
    port, jax_pkg = tmp_path / "a.py", tmp_path / "b.py"
    port.write_text("import rtvm_tpu_torch.kernels\nfrom rtvm_tpu_torch import config\n")
    jax_pkg.write_text("from rtvm_tpu.ops import warp\n")
    assert not top_names(port) & FORBIDDEN
    assert top_names(jax_pkg) & FORBIDDEN == {"rtvm_tpu"}
