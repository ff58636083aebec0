"""What the benchmark's modules import, read from their source: none
imports jax, jaxlib, flax or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and no plain
reference imports the program; nothing reads bench.py or benchmarks/."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lyssandra_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))
REFERENCES = sorted(BENCH.glob("reference/*.py")) + sorted(
    BENCH.glob("configs/*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_references_import_no_program(path):
    assert "lyssandra_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"portbench", "numpy", "torch",
                                       "contextlib"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_nothing_reads_the_jax_benchmark(path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    if path.name == Path(__file__).name:
        return
    for n in ast.walk(tree):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and id(n) not in docs:
            assert "bench.py" not in n.value and "benchmarks" not in n.value


def test_the_check_is_by_whole_top_level_name():
    from portbench.core import harness

    assert "lyssandra_tpu" in harness.FORBIDDEN
    name = "lyssandra_tpu_torch.ops"
    assert name.split(".")[0] not in harness.FORBIDDEN
