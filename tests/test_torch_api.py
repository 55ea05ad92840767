"""The port's public surface against the JAX reference's.

Every module of ``src/repro/`` is read with ``ast`` (so no JAX trace runs
and nothing of the reference is imported), and each of its public names
must be importable from the port's counterpart by the same dotted path
(``repro.core.bulk.bulk_update_all`` -> ``repro_torch.core.bulk``). A
module's public names are the top-level functions, classes and assigned
names that do not start with ``_``; a package ``__init__`` adds the names
it imports from its modules, or gives its ``__all__``.

The deliberate differences (ROADMAP A) are one list, ``DELIBERATE``, of
``module:name`` patterns; every pattern must still match a name the port
leaves out, so the list cannot outlive its reasons.
"""
import ast
import fnmatch
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

# patterns over the reference's "module:name", each with ROADMAP A's reason
DELIBERATE = [
    # the jit wrappers have no counterpart: the port's functions run eagerly
    # or launch their kernels as they are
    "repro.core*:*_jit",
    # the process-wide backend setters became per-engine EngineConfig.ingest
    # and EngineConfig.multisearch, and per-call search=/backend=
    "repro.primitives*:multisearch_backend",
    "repro.primitives*:set_multisearch_backend",
    "repro.primitives.ingest:ingest_backend",
    "repro.primitives.ingest:set_ingest_backend",
    # an XLA compile counter; the port counts kernel builds and loads in
    # repro_torch.kernels.LIBRARY_EVENTS
    "repro.engine*:XlaCompileCounter",
    # picks Pallas interpret mode off the TPU; the port's wrappers pick the
    # CUDA kernel or the plain version by the tensors' device
    "repro.kernels.ops:*",
    # only sets XLA_FLAGS for --host-devices; the port's launch/mesh.py takes
    # host_devices directly
    "repro.launch._env:*",
    # parses XLA's partitioned HLO text, which the port never produces;
    # roofline/collectives.py counts or derives the collectives
    "repro.roofline.hlo:*",
    # renamed: the Pallas segment sum's wrapper is kernels/segment_sum.py's
    # segment_sum in the port; the jnp wrapper over multisearch_counts is
    # primitives/search.py::exact_multisearch (backend="kernel")
    "repro.kernels.multisearch:exact_multisearch_kernel",
    "repro.kernels.segment_sum:segment_sum_kernel",
    # the TPU's 128-lane tile width, which no CUDA kernel of the port uses
    "repro.kernels.segscan:LANE",
    # the TPU's inter-chip rate is NVLINK_BW in the port
    "repro.roofline.report:ICI_BW",
    # the alias Array = jax.Array; the port annotates torch.Tensor
    "repro.*:Array",
]


def _module_name(path: Path) -> str:
    parts = ("repro",) + path.relative_to(REF).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _assigned(target) -> list:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _assigned(elt)]
    return []


def _top_level(body) -> list:
    """Names bound at a module's top level, through its ``if`` and ``try``
    blocks."""
    names = []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [n for t in node.targets for n in _assigned(t)]
        elif isinstance(node, ast.AnnAssign):
            names += _assigned(node.target)
        elif isinstance(node, ast.If):
            names += _top_level(node.body) + _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            names += _top_level(node.body) + _top_level(node.orelse)
            names += [n for h in node.handlers for n in _top_level(h.body)]
    return names


def public_names(path: Path) -> list:
    """The reference module's public names, in source order."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and _assigned(node.targets[0]) == ["__all__"]):
            return [ast.literal_eval(e) for e in node.value.elts]
    names = _top_level(tree.body)
    if path.name == "__init__.py":
        names += [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                  for a in node.names]
    seen = {}
    for n in names:
        if not n.startswith("_"):
            seen.setdefault(n, None)
    return list(seen)


def deliberate(module: str, name: str) -> bool:
    return any(fnmatch.fnmatchcase(f"{module}:{name}", p) for p in DELIBERATE)


REF_MODULES = {_module_name(p): p for p in sorted(REF.rglob("*.py"))}


def test_the_scan_sees_the_reference():
    assert len(REF_MODULES) > 60
    core = public_names(REF / "core" / "__init__.py")
    assert "bulk_update_all_jit" in core and "GLOBAL" in core
    assert public_names(REF / "__init__.py") == []  # `import jax` and __version__
    assert "GLOBAL" in public_names(REF / "core" / "schemes.py")


@pytest.mark.parametrize("module", sorted(REF_MODULES))
def test_every_public_name_has_a_counterpart(module):
    names = [n for n in public_names(REF_MODULES[module]) if not deliberate(module, n)]
    if not names and deliberate(module, "*"):
        return  # a module the port has no counterpart of (DELIBERATE)
    port = importlib.import_module("repro_torch" + module[len("repro"):])
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("pattern", DELIBERATE)
def test_every_deliberate_difference_is_still_one(pattern):
    """Each pattern matches a reference name the port really leaves out."""
    hits = []
    for module, path in REF_MODULES.items():
        for name in public_names(path):
            if fnmatch.fnmatchcase(f"{module}:{name}", pattern):
                try:
                    port = importlib.import_module("repro_torch" + module[len("repro"):])
                except ModuleNotFoundError:
                    hits.append((module, name))
                    continue
                if not hasattr(port, name):
                    hits.append((module, name))
    assert hits, f"{pattern} excuses nothing: drop it from DELIBERATE"


def test_package_all_follows_the_reference():
    """``repro_torch.core`` and ``repro_torch.primitives`` export the
    reference's ``__all__`` in its order, less the deliberate differences,
    and nothing else."""
    for pkg in ("core", "primitives"):
        want = [n for n in public_names(REF / pkg / "__init__.py")
                if not deliberate(f"repro.{pkg}", n)]
        port = importlib.import_module(f"repro_torch.{pkg}")
        assert port.__all__ == want


def test_estimate_names_the_function_and_its_module_stays_reachable():
    import repro_torch.core as core
    from repro_torch.core.estimate import estimate as est_fn
    from repro_torch.core.schemes import GLOBAL, GlobalScheme

    assert callable(core.estimate) and core.estimate is est_fn
    assert sys.modules["repro_torch.core.estimate"].estimate is est_fn
    assert core.GLOBAL is GLOBAL and type(GLOBAL) is GlobalScheme


STATEMENTS = [
    "import repro_torch.kernels",
    "import repro_torch.core",
    "import repro_torch.primitives",
    "from repro_torch.core import GLOBAL, bulk_update_all, estimate, init_state; "
    "from repro_torch.primitives import multisearch_bounds, sort_by_key",
]


def test_imports_alone_in_a_fresh_process():
    """Each statement alone in a fresh process (the four at once): no import
    cycle between the packages' ``__init__``s, and no JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    check = ("\nimport sys\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
             "assert not bad, bad\n")
    procs = [subprocess.Popen([sys.executable, "-c", stmt + check], env=env,
                              stderr=subprocess.PIPE, text=True) for stmt in STATEMENTS]
    errs = {stmt: p.communicate(timeout=120)[1] for stmt, p in zip(STATEMENTS, procs)}
    failed = {stmt: err for (stmt, err), p in zip(errs.items(), procs) if p.returncode}
    assert not failed, failed
