"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names, compared
whole (the port's name begins with the JAX package's)."""
import ast

from bench.tests.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _files(sub=""):
    return sorted((ROOT / "bench" / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _files():
        assert not _imports(path) & BANNED, path
    assert "repro_torch" not in BANNED  # compared whole: the port is allowed


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        names = _imports(path)
        assert "repro_torch" not in names and not names & BANNED, path


def test_no_module_reads_the_old_benchmarks():
    for path in _files():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_streaming" not in text, path
