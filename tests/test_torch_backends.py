"""The port's tenant-sharded banks and ``select_backend`` against the JAX
reference on the same mesh shapes.

As in ``tests/test_torch_distributed.py``, the JAX side runs once in a
subprocess with 8 host devices (the file runs itself as a script), builds
its meshes with ``repro.launch.mesh.make_stream_mesh`` (``Auto`` axes) and
writes JSON that a module-scoped fixture reads; the port side runs here on
CPU meshes (``host_devices``). Tolerance: exact (sha256 of the state, of
the estimate and of the per-vertex answer). Sizes: r = 512, s = 32, a bank
of 4 tenants on four distinct streams of 105-126 edges.

Covered: banked_pjit_independent and banked_pjit_coordinated on
``tenants=4`` and ``tenants=2,estimators=2`` under global and local, per
batch and chunked (K = 2), each equal to the reference's engine and to the
port's ``single`` bank; their device-resident query against ``gather=True``
and the reference, and ``make_banked_estimate(partials_only=True)``; and
``select_backend``'s plan or error text over a grid of tenant counts, mesh
specs, r, s, schemes and chunk sizes, for every backend name and ``auto``.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.schemes import resolve_scheme  # noqa: E402
from repro_torch.data.graph_stream import batches, planted_triangle_stream  # noqa: E402
from repro_torch.engine import EngineConfig, TriangleCountEngine  # noqa: E402
from repro_torch.engine.backends import BACKENDS, select_backend  # noqa: E402
from repro_torch.interop import estimate_sha256, from_jax_snapshot, state_sha256  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

R, S, T, K = 512, 32, 4, 2
LOCAL = (("n_pools", 4), ("n_vertices", 60))
BANK_CASES = [(w, spec, scheme, chunk)
              for w in ("independent", "coordinated")
              for spec in ("tenants=4", "tenants=2,estimators=2")
              for scheme in ("global", "local")
              for chunk in (1, K)]
GRID_SPECS = ("", "1", "4", "8", "tenants=2", "tenants=4", "tenants=2,estimators=2",
              "estimators=2,tenants=2", "tenants=4,estimators=2", "data=2,model=4")
GRID = list(itertools.product((1, 2, 4), GRID_SPECS, (512, 500), (32, 30),
                              ("global", "naive"), (1, 2)))


def _streams():
    """Four tenants' streams of 126, 119, 112 and 105 edges: 4 batches each,
    the last ragged."""
    return [planted_triangle_stream(12, 90 - 7 * t, 60, seed=3 + t)[0] for t in range(T)]


def _bank_batches():
    """(T, 4, s, 2) padded batches and their (T, 4) counts."""
    per = [list(batches(e, S)) for e in _streams()]
    Wb = np.stack([np.stack([W for W, _ in p]) for p in per]).astype(np.int32)
    nv = np.array([[n for _, n in p] for p in per], np.int64)
    return Wb, nv


def _scheme_kw(scheme):
    return {"scheme": "local", "scheme_params": LOCAL} if scheme == "local" else {}


def _digest(x) -> str:
    return estimate_sha256(np.asarray(x, np.float64))


def _drive(e, chunk):
    Wb, nv = _bank_batches()
    if chunk == 1:
        for i in range(Wb.shape[1]):
            e.ingest(Wb[:, i], nv[:, i])
    else:
        for i in range(0, Wb.shape[1], chunk):
            e.ingest_chunk(Wb[:, i:i + chunk], nv[:, i:i + chunk])


def _key(w, spec, scheme, chunk):
    return f"{w}/{spec}/{scheme}/{chunk}"


def _grid_key(case):
    return "/".join(map(str, case))


# ---------------------------------------------------------------------------
# the JAX side (run as a script in its own process)
# ---------------------------------------------------------------------------
def _jax_side(out_path: str) -> None:
    import jax

    import repro  # noqa: F401  -- x64
    from repro.core.distributed import make_banked_estimate
    from repro.core.schemes import resolve_scheme as jresolve
    from repro.engine import EngineConfig as JConfig
    from repro.engine import TriangleCountEngine as JEngine
    from repro.engine.backends import select_backend as jselect
    from repro.launch.mesh import make_stream_mesh

    assert jax.device_count() == 8, jax.device_count()
    res = {"bank": {}, "grid": {}}
    for w, spec, scheme, chunk in BANK_CASES:
        mesh = make_stream_mesh(spec)
        e = JEngine(JConfig(r=R, batch_size=S, n_tenants=T, seeds=tuple(range(T)),
                            backend=f"banked_pjit_{w}", chunk_size=chunk, **_scheme_kw(scheme)),
                    mesh=mesh)
        _drive(e, chunk)
        parts = make_banked_estimate(mesh, R, "tenants", jresolve(scheme, LOCAL if scheme ==
                                                                   "local" else None),
                                     groups=9, partials_only=True)(e._state)
        res["bank"][_key(w, spec, scheme, chunk)] = {
            "sha": state_sha256(from_jax_snapshot(e.snapshot())), "est": _digest(e.estimate()),
            "gather": _digest(e.estimate(gather=True)), "plan": e.plan.name,
            "partials": _digest(parts), "partials_shape": list(np.shape(parts))}
    meshes = {spec: make_stream_mesh(spec) for spec in GRID_SPECS}
    for backend in ("auto",) + BACKENDS:
        for case in GRID:
            t, spec, r, s, scheme, chunk = case
            cfg = JConfig(r=r, batch_size=s, n_tenants=t, backend=backend, scheme=scheme,
                          chunk_size=chunk)
            try:
                got = jselect(cfg, meshes[spec]).name
            except ValueError as exc:
                got = "error: " + str(exc)
            res["grid"][f"{backend}/{_grid_key(case)}"] = got
    Path(out_path).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_banks") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _single(scheme, chunk):
    e = TriangleCountEngine(EngineConfig(r=R, batch_size=S, n_tenants=T, seeds=tuple(range(T)),
                                         chunk_size=chunk, device="cpu", **_scheme_kw(scheme)))
    _drive(e, chunk)
    return e


@pytest.mark.parametrize("w,spec,scheme,chunk", BANK_CASES)
def test_banked_plans_match_reference_and_single(ref, w, spec, scheme, chunk):
    mesh = tmesh.make_stream_mesh(spec, "cpu", 8)
    e = TriangleCountEngine(EngineConfig(r=R, batch_size=S, n_tenants=T, seeds=tuple(range(T)),
                                         backend=f"banked_pjit_{w}", chunk_size=chunk,
                                         device="cpu", **_scheme_kw(scheme)), mesh=mesh)
    _drive(e, chunk)
    parts = distributed.make_banked_estimate(
        mesh, R, "tenants", resolve_scheme(scheme, LOCAL if scheme == "local" else None),
        groups=9, partials_only=True)(e._state)
    got = {"sha": state_sha256(e.snapshot()), "est": _digest(e.estimate()),
           "gather": _digest(e.estimate(gather=True)), "plan": e.plan.name,
           "partials": _digest(parts.cpu().numpy()), "partials_shape": list(parts.shape)}
    assert got == ref["bank"][_key(w, spec, scheme, chunk)]
    assert got["est"] == got["gather"]  # the device query equals the gather oracle
    single = _single(scheme, chunk)
    assert got["sha"] == state_sha256(single.snapshot())
    assert got["est"] == _digest(single.estimate())


@pytest.mark.parametrize("backend", ("auto",) + BACKENDS)
def test_select_backend_matches_reference_over_a_grid(ref, backend):
    meshes = {spec: tmesh.make_stream_mesh(spec, "cpu", 8) for spec in GRID_SPECS}
    mismatched = []
    for case in GRID:
        t, spec, r, s, scheme, chunk = case
        cfg = EngineConfig(r=r, batch_size=s, n_tenants=t, backend=backend, scheme=scheme,
                           chunk_size=chunk, device="cpu")
        try:
            got = select_backend(cfg, meshes[spec]).name
        except ValueError as exc:
            got = "error: " + str(exc)
        want = ref["grid"][f"{backend}/{_grid_key(case)}"]
        if got != want:
            mismatched.append((case, got, want))
    assert not mismatched, mismatched[:5]


if __name__ == "__main__":
    _jax_side(sys.argv[1])
