"""The port's sharded plans against the JAX reference on the same mesh shape.

The reference's meshes need 8 host devices, fixed when jax first
initialises, so this file runs its JAX side once in a subprocess: the file
runs itself as a script under ``XLA_FLAGS=--xla_force_host_platform_
device_count=8`` and ``JAX_PLATFORMS=cpu``, builds every reference mesh
with ``repro.launch.mesh`` (``Auto`` axes) and writes its results to JSON,
which a module-scoped fixture reads. The port side runs here, on CPU meshes
whose shards all lie on the CPU (``host_devices``).

Tolerance: exact. States are compared by sha256 of every field (and of
the window ring none of these runs keeps), estimates bit for bit. Sizes:
r = 512, s = 32, streams of about 100 edges (``tests/_dist_driver.py``).
Covered: pjit_independent and pjit_coordinated under global and local on a
(2, 4) mesh, equal to the reference's and to the port's ``single``;
shardmap on (2, 4) and ``estimators=4``, equal to the reference's
``make_coordinated_update`` batch by batch with its overflow; a forced
overflow and its capacity escalations; deletions on sharded plans; the
device-resident query against ``gather=True``; snapshots across mesh
shapes and packages; the reference's ``TestDeviceQueryDegradation`` cases;
``make_stream_mesh``'s grammar and errors; the CLI's ``--backend/--mesh/
--host-devices`` lines. Also: shards of ``fused_ingest_plain`` and of
``bulk_update_all`` at their estimator offsets concatenate to the full
call (and, on a card, shards of the ``fused_ingest`` kernel).
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core import bulk, distributed  # noqa: E402
from repro_torch.core.rank import rank_all_chunk  # noqa: E402
from repro_torch.core.state import EstimatorState, init_state  # noqa: E402
from repro_torch.data.graph_stream import (  # noqa: E402
    batches,
    churn_stream,
    erdos_renyi_stream,
    planted_triangle_stream,
    signed_batches,
)
from repro_torch.engine import EngineConfig, TriangleCountEngine  # noqa: E402
from repro_torch.engine.faults import FaultPlan, FaultSpec, fault_plan  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    estimate_sha256,
    from_jax_snapshot,
    state_sha256,
    to_jax_snapshot,
    window_sha256,
)
from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_plain  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

R, S = 512, 32
LOCAL = (("n_pools", 4), ("n_vertices", 60))
MESHES = {"2x4": ((2, 4), ("data", "model")), "estimators=4": "estimators=4",
          "tenants=2,estimators=2": "tenants=2,estimators=2", "tenants=4": "tenants=4",
          "1": "1"}
CLI_CASES = {
    "bank_2x2": ["--tenants", "4", "--chunk", "2", "--mesh", "tenants=2,estimators=2",
                 "--host-devices", "4"],
    "pjit_local": ["--mesh", "4", "--host-devices", "4", "--backend", "pjit_independent",
                   "--scheme", "local", "--pools", "4"],
}
# the shardmap engine under each scheme, one mesh each (the raw update runs
# on both meshes)
SHARDMAP_CASES = (("2x4", "local"), ("estimators=4", "global"))
CLI_COMMON = ["--graph", "er", "--nodes", "40", "--edges", "300", "--estimators", "512",
              "--batch", "32"]
BAD_SPECS = ("x=a", "0", "a=2,a=2", "16", "tenants=0")
# chip_smoke.py's cli phase runs these flags on the card
PLANS_GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "plans_small.json"
PLANS_ARGS = ["--graph", "planted", "--triangles", "150", "--edges", "2000", "--nodes", "3000",
              "--estimators", "4096", "--batch", "256", "--chunk", "4", "--tenants", "4",
              "--mesh", "tenants=2,estimators=2", "--host-devices", "4"]


def _planted():
    edges, _ = planted_triangle_stream(12, 90, 60, seed=3)
    return edges  # 126 edges: 3 full batches and a ragged one of 30


def _hub():
    """A star of 240 edges around vertex 0 among 80 noise edges: vertex 0's
    arcs crowd one bucket."""
    g = np.random.default_rng(11)
    star = np.stack([np.zeros(240, np.int64), np.arange(1, 241)], 1)
    noise = g.integers(1, 241, size=(80, 2))
    noise = noise[noise[:, 0] != noise[:, 1]]
    edges = np.concatenate([star, noise]).astype(np.int32)
    return edges[g.permutation(len(edges))]


def _scheme_kw(scheme):
    return {"scheme": "local", "scheme_params": LOCAL} if scheme == "local" else {}


SERVICE_CASES = (("pjit_coordinated", "2x4"), ("shardmap", "estimators=4"))
# window and decay on the sharded plans: (plan, mesh, T, K, mode)
WINDOW_CASES = (("banked_pjit_coordinated", "tenants=2,estimators=2", 2, 2, {"window": 40}),
                ("banked_pjit_independent", "tenants=4", 4, 1, {"decay": 15.0}),
                ("pjit_independent", "2x4", 1, 1, {"window": 40}))
SERVICE_FAULTS = "engine.estimate:raise@1x2"


def _ignore(step, ests, seen) -> None:
    """A report callback: the reports' queries are what is under test."""


def _report(rep) -> dict:
    return {k: getattr(rep, k) for k in ("batches", "edges", "queries", "query_fallbacks",
                                         "degraded_queries", "retries")}


def _digest(est) -> str:
    return estimate_sha256(np.asarray(est, np.float64))


# ---------------------------------------------------------------------------
# the JAX side (run as a script in its own process)
# ---------------------------------------------------------------------------
def _jax_side(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    import repro  # noqa: F401  -- x64
    from repro.core.distributed import make_coordinated_update
    from repro.core.state import init_state as jinit
    from repro.engine import EngineConfig as JConfig
    from repro.engine import TriangleCountEngine as JEngine
    from repro.engine import faults as jfaults
    from repro.launch import mesh as jmesh

    assert jax.device_count() == 8, jax.device_count()

    def mesh(name):
        m = MESHES[name]
        return jmesh.make_test_mesh(*m) if isinstance(m, tuple) else jmesh.make_stream_mesh(m)

    def eng_out(e, extra=None):
        snap = e.snapshot()
        out = {"sha": state_sha256(from_jax_snapshot(snap)), "est": _digest(e.estimate()),
               "gather": _digest(e.estimate(gather=True)), "plan": e.plan.name,
               "diag": {k: getattr(e.diag, k) for k in (
                   "overflow_batches", "capacity_escalations", "delete_batches",
                   "query_fallbacks", "query_timeouts", "pending_overflow_dropped")},
               "capacity_factor": e.config.capacity_factor}
        out.update(extra or {})
        return out

    res = {}
    for w in ("independent", "coordinated"):
        for scheme in ("global", "local"):
            e = JEngine(JConfig(r=R, batch_size=S, seeds=(0,), backend=f"pjit_{w}",
                                **_scheme_kw(scheme)), mesh=mesh("2x4"))
            for W, nv in batches(_planted(), S):
                e.ingest(W, nv)
            res[f"pjit/{w}/{scheme}"] = eng_out(e)

    key = jax.random.PRNGKey(0)
    for name in ("2x4", "estimators=4"):
        upd = make_coordinated_update(mesh(name), r=R, s=S, capacity_factor=2.0)
        st = jinit(R)
        ovf = []
        for i, (W, nv) in enumerate(batches(_planted(), S)):
            st, o = upd(st, jnp.asarray(W), jnp.int32(nv), jax.random.fold_in(key, i))
            ovf.append(int(o))
        snap = {f: np.asarray(getattr(st, f))[None] for f in st._fields}
        snap.update(root_keys=np.asarray(key)[None], step=np.int64(len(ovf)),
                    config=np.array([R, S, 1], np.int64))
        res[f"raw_shardmap/{name}"] = {"sha": state_sha256(from_jax_snapshot(snap)),
                                       "overflow": ovf}
    for name, scheme in SHARDMAP_CASES:
        e = JEngine(JConfig(r=R, batch_size=S, seeds=(0,), backend="shardmap",
                            **_scheme_kw(scheme)), mesh=mesh(name))
        for W, nv in batches(_planted(), S):
            e.ingest(W, nv)
        res[f"shardmap/{name}/{scheme}"] = eng_out(e)

    e = JEngine(JConfig(r=R, batch_size=S, seeds=(0,), backend="shardmap",
                        capacity_factor=0.5), mesh=mesh("estimators=4"))
    _overflow_run(e)
    res["overflow"] = eng_out(e)

    stream = churn_stream(_planted(), 0.3, seed=4)
    for plan, name, T in (("pjit_coordinated", "2x4", 1), ("shardmap", "estimators=4", 1),
                          ("banked_pjit_coordinated", "tenants=2,estimators=2", 2)):
        e = JEngine(JConfig(r=R, batch_size=S, n_tenants=T, seeds=tuple(range(T)),
                            backend=plan), mesh=mesh(name))
        e.ingest_signed_stream(signed_batches(stream, S))
        res[f"delete/{plan}"] = eng_out(e)
    for plan, name, T, K, mode in WINDOW_CASES:
        e = JEngine(JConfig(r=R, batch_size=S, n_tenants=T, seeds=tuple(range(T)),
                            chunk_size=K, backend=plan, **mode), mesh=mesh(name))
        e.ingest_stream(batches(_planted(), S))
        res[f"window/{plan}"] = eng_out(e, {"ring": window_sha256(from_jax_snapshot(
            e.snapshot())), "expired": e.diag.window_expired})

    # snapshots: a reference mesh engine's mid-stream snapshot for the port,
    # and a port mesh engine's snapshot restored into reference meshes
    its = list(batches(_planted(), S))
    e = JEngine(JConfig(r=R, batch_size=S, n_tenants=4, seeds=(0, 1, 2, 3),
                        backend="banked_pjit_coordinated"), mesh=mesh("tenants=2,estimators=2"))
    for W, nv in its[:2]:
        e.ingest(W, nv)
    snap_path = Path(out_path).with_suffix(".snap.npz")
    np.savez(snap_path, **e.snapshot())
    res["snap_path"] = str(snap_path)
    for W, nv in its[2:]:
        e.ingest(W, nv)
    res["snap_end"] = eng_out(e)
    port = TriangleCountEngine(EngineConfig(r=R, batch_size=S, n_tenants=4,
                                            seeds=(0, 1, 2, 3), device="cpu"),
                               mesh=tmesh.make_stream_mesh("tenants=4", "cpu", 8))
    for W, nv in its[:2]:
        port.ingest(W, nv)
    psnap = to_jax_snapshot(port.snapshot())
    for spec, plan in (("tenants=2,estimators=2", "banked_pjit_independent"), ("", "single")):
        j = JEngine.from_snapshot(psnap, mesh=jmesh.make_stream_mesh(spec) if spec else None,
                                  backend=plan)
        for W, nv in its[2:]:
            j.ingest(W, nv)
        res[f"from_port/{plan}"] = eng_out(j)

    def degr():
        e = JEngine(JConfig(r=R, batch_size=S, n_tenants=1, seeds=(0,),
                            backend="pjit_coordinated"), mesh=mesh("1"))
        its = list(batches(erdos_renyi_stream(60, 400, seed=0), S))
        e.ingest(*its[0])
        return e

    for case, spec, timeout in (("fault", ("raise", 0.0), None),
                                ("timeout", ("delay", 0.6), 0.05), ("clean", None, 5.0)):
        e = degr()
        plan = (jfaults.FaultPlan([jfaults.FaultSpec("engine.estimate", spec[0],
                                                     delay_s=spec[1])])
                if spec else jfaults.FaultPlan([]))
        with jfaults.fault_plan(plan):
            out = e.estimate(timeout_s=timeout)
        res[f"degrade/{case}"] = eng_out(e, {"answer": _digest(out)})

    from repro.engine import ResilienceConfig as JRes
    from repro.engine import run_stream as jrun

    for plan, name in SERVICE_CASES:
        e = JEngine(JConfig(r=R, batch_size=S, seeds=(0,), backend=plan), mesh=mesh(name))
        with jfaults.fault_plan(jfaults.parse_fault_plan(SERVICE_FAULTS)):
            rep = jrun(e, batches(_planted(), S), report_every=1, on_report=_ignore,
                       resilience=JRes(query_timeout_s=5.0))
        res[f"service/{plan}"] = eng_out(e, {"report": _report(rep)})

    for name, args in CLI_CASES.items():
        res[f"cli/{name}"] = _cli_lines(_jax_cli(CLI_COMMON + args))

    errs = {}
    for spec in BAD_SPECS:
        try:
            jmesh.make_stream_mesh(spec)
            errs[spec] = None
        except ValueError as exc:
            errs[spec] = str(exc)
    m = jmesh.make_stream_mesh("tenants=2,estimators=4")
    res["mesh"] = {"errors": errs, "shape": dict(m.shape), "axes": list(jmesh.mesh_axes(m))}
    Path(out_path).write_text(json.dumps(res))


def _jax_cli(args) -> str:
    from repro.launch import stream as jcli

    buf = io.StringIO()
    with redirect_stdout(buf):
        old = sys.argv
        sys.argv = ["stream"] + args + ["--ckpt-every", "0"]
        try:
            jcli.main()
        finally:
            sys.argv = old
    return buf.getvalue()


def _write_golden() -> None:
    """The JAX CLI's mesh: and estimate lines for PLANS_ARGS (run with 8
    host devices: ``python tests/test_torch_distributed.py --write``)."""
    lines = [ln for ln in _jax_cli(PLANS_ARGS).splitlines()
             if ln.startswith(("mesh:", "estimate"))]
    PLANS_GOLDEN.write_text(json.dumps({"args": PLANS_ARGS, "lines": lines}, indent=1) + "\n")


def _cli_lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if ln.startswith(("estimate", "local[", "mesh:", "stream:"))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dist") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# the port side
# ---------------------------------------------------------------------------
def _mesh(name):
    m = MESHES[name]
    if isinstance(m, tuple):
        return tmesh.make_test_mesh(*m)
    return tmesh.make_stream_mesh(m, device="cpu", host_devices=8)


def _engine(plan, mesh_name, T=1, scheme="global", **kw):
    return TriangleCountEngine(
        EngineConfig(r=R, batch_size=S, n_tenants=T, seeds=tuple(range(T)), backend=plan,
                     device="cpu", **_scheme_kw(scheme), **kw),
        mesh=_mesh(mesh_name) if mesh_name else None)


def _out(e, extra=None):
    snap = e.snapshot()
    out = {"sha": state_sha256(snap), "est": _digest(e.estimate()),
           "gather": _digest(e.estimate(gather=True)), "plan": e.plan.name,
           "diag": {k: getattr(e.diag, k) for k in (
               "overflow_batches", "capacity_escalations", "delete_batches",
               "query_fallbacks", "query_timeouts", "pending_overflow_dropped")},
           "capacity_factor": e.config.capacity_factor}
    out.update(extra or {})
    return out


def _single(scheme="global"):
    e = _engine("single", None, scheme=scheme)
    for W, nv in batches(_planted(), S):
        e.ingest(W, nv)
    return e


@pytest.mark.parametrize("scheme", ["global", "local"])
@pytest.mark.parametrize("w", ["independent", "coordinated"])
def test_pjit_plans_match_reference_and_single(ref, w, scheme):
    e = _engine(f"pjit_{w}", "2x4", scheme=scheme)
    for W, nv in batches(_planted(), S):
        e.ingest(W, nv)
    got = _out(e)
    assert got == ref[f"pjit/{w}/{scheme}"]
    assert got["est"] == got["gather"]
    single = _single(scheme)
    assert got["sha"] == state_sha256(single.snapshot())
    assert got["est"] == _digest(single.estimate())


@pytest.mark.parametrize("name", ["2x4", "estimators=4"])
def test_shardmap_matches_reference_coordinated_update(ref, name):
    mesh = _mesh(name)
    upd = distributed.make_coordinated_update(mesh, R, S, 2.0)
    layout = distributed.scheme_state_sharding(mesh, "global", mesh.axis_names, r=R)
    st = distributed.ShardedState(layout.shard(init_state(R)), layout)
    key = rng.PRNGKey(0)
    ovf = []
    for i, (W, nv) in enumerate(batches(_planted(), S)):
        st, o = upd(st, torch.from_numpy(W), nv, rng.fold_in(key, i))
        ovf.append(int(o))
    full = st.gather("cpu")
    snap = {f: getattr(full, f).numpy()[None] for f in EstimatorState._fields}
    snap.update(root_keys=rng.PRNGKey(0).numpy()[None].astype(np.uint32),
                step=np.int64(len(ovf)), config=np.array([R, S, 1], np.int64))
    want = ref[f"raw_shardmap/{name}"]
    assert ovf == want["overflow"]
    assert state_sha256(snap) == want["sha"]


@pytest.mark.parametrize("name,scheme", SHARDMAP_CASES)
def test_shardmap_engine_matches_reference(ref, name, scheme):
    e = _engine("shardmap", name, scheme=scheme)
    for W, nv in batches(_planted(), S):
        e.ingest(W, nv)
    got = _out(e)
    assert got == ref[f"shardmap/{name}/{scheme}"]
    assert got["est"] == got["gather"]  # the device query equals the oracle
    if scheme == "global":
        assert got["sha"] == ref[f"raw_shardmap/{name}"]["sha"]


def _overflow_run(e):
    """The hub stream at capacity factor 0.5: three batches, a snapshot,
    three more, a restore of the snapshot (which drops those three batches'
    undrained overflow scalars), then the stream on from batch 3, whose
    overflows escalate the capacity."""
    its = list(batches(_hub(), S))
    for W, nv in its[:3]:
        e.ingest(W, nv)
    snap = e.snapshot()
    for W, nv in its[3:6]:
        e.ingest(W, nv)
    e.restore(snap)
    for W, nv in its[3:]:
        e.ingest(W, nv)


def test_forced_overflow_escalates_as_the_reference(ref):
    e = _engine("shardmap", "estimators=4", capacity_factor=0.5)
    _overflow_run(e)
    got = _out(e)
    assert got["diag"]["overflow_batches"] >= 1
    assert got["diag"]["pending_overflow_dropped"] == 3
    assert got == ref["overflow"]


@pytest.mark.parametrize("plan,name,T", [("pjit_coordinated", "2x4", 1),
                                         ("shardmap", "estimators=4", 1),
                                         ("banked_pjit_coordinated", "tenants=2,estimators=2", 2)])
def test_deletions_on_sharded_plans_match_reference(ref, plan, name, T):
    e = _engine(plan, name, T=T)
    e.ingest_signed_stream(signed_batches(churn_stream(_planted(), 0.3, seed=4), S))
    got = _out(e)
    assert got["diag"]["delete_batches"] > 0
    assert got == ref[f"delete/{plan}"]


@pytest.mark.parametrize("plan,name,T,K,mode", WINDOW_CASES)
def test_window_and_decay_on_sharded_plans_match_reference(ref, plan, name, T, K, mode):
    """The reference runs a windowed (or decayed) bank on its banked plans,
    and a windowed tenant on pjit: so does the port, to the same state and
    rings."""
    e = _engine(plan, name, T=T, chunk_size=K, **mode)
    e.ingest_stream(batches(_planted(), S))
    got = _out(e, {"ring": window_sha256(e.snapshot()), "expired": e.diag.window_expired})
    assert got["expired"] > 0
    assert got == ref[f"window/{plan}"]


@pytest.mark.parametrize("spec,plan", [("", "single"), ("tenants=4", "banked_pjit_independent"),
                                       ("tenants=2,estimators=2", "banked_pjit_coordinated"),
                                       ("tenants=2", "banked_pjit_independent")])
def test_reference_mesh_snapshot_restores_onto_any_port_mesh(ref, spec, plan):
    snap = from_jax_snapshot(dict(np.load(ref["snap_path"])))
    e = TriangleCountEngine.from_snapshot(
        snap, mesh=tmesh.make_stream_mesh(spec, "cpu", 8) if spec else None, backend=plan,
        device="cpu")
    assert e.plan.name == plan
    for W, nv in list(batches(_planted(), S))[2:]:
        e.ingest(W, nv)
    got = _out(e)
    want = ref["snap_end"]
    assert (got["sha"], got["est"]) == (want["sha"], want["est"])


@pytest.mark.parametrize("plan", ["banked_pjit_independent", "single"])
def test_port_mesh_snapshot_restores_into_reference_meshes(ref, plan):
    want = ref[f"from_port/{plan}"]
    assert want["sha"] == ref["snap_end"]["sha"]
    assert want["est"] == ref["snap_end"]["est"]


@pytest.mark.parametrize("src,dst", [("tenants=4", "tenants=2,estimators=2"),
                                     ("tenants=2,estimators=2", "tenants=4"),
                                     ("tenants=2,estimators=2", ""),
                                     ("", "tenants=2,estimators=2")])
def test_port_snapshots_cross_mesh_shapes(src, dst):
    its = list(batches(_planted(), S))

    def eng(spec):
        return TriangleCountEngine(
            EngineConfig(r=R, batch_size=S, n_tenants=4, seeds=(0, 1, 2, 3), device="cpu"),
            mesh=tmesh.make_stream_mesh(spec, "cpu", 8) if spec else None)

    a, whole = eng(src), eng("")
    for W, nv in its[:2]:
        a.ingest(W, nv)
    b = eng(dst)
    b.restore(a.snapshot())
    for W, nv in its[2:]:
        b.ingest(W, nv)
    for W, nv in its:
        whole.ingest(W, nv)
    assert state_sha256(b.snapshot()) == state_sha256(whole.snapshot())
    np.testing.assert_array_equal(b.estimate(), whole.estimate())


def _degraded_engine():
    e = _engine("pjit_coordinated", "1")
    assert e._estimate_device is not None
    e.ingest(*next(iter(batches(erdos_renyi_stream(60, 400, seed=0), S))))
    return e


def test_faulted_device_query_falls_back_to_gather(ref):
    e = _degraded_engine()
    want = e.estimate(gather=True).copy()
    with fault_plan(FaultPlan([FaultSpec("engine.estimate", "raise")])):
        out = e.estimate()
    assert (e.diag.query_fallbacks, e.diag.query_timeouts) == (1, 0)
    np.testing.assert_array_equal(out, want)
    assert e.estimate() is out  # the degraded answer is exact, so it is cached
    got = _out(e, {"answer": _digest(out)})
    assert got == ref["degrade/fault"]


def test_timed_out_device_query_falls_back_to_gather(ref):
    e = _degraded_engine()
    with fault_plan(FaultPlan([FaultSpec("engine.estimate", "delay", delay_s=0.6)])):
        out = e.estimate(timeout_s=0.05)
    assert (e.diag.query_timeouts, e.diag.query_fallbacks) == (1, 1)
    np.testing.assert_array_equal(out, e.estimate(gather=True))
    assert _out(e, {"answer": _digest(out)}) == ref["degrade/timeout"]


def test_no_timeout_no_fault_uses_device_path(ref):
    e = _degraded_engine()
    with fault_plan(FaultPlan([])):
        out = e.estimate(timeout_s=5.0)
    assert e.diag.query_fallbacks == 0
    np.testing.assert_array_equal(out, e.estimate(gather=True))
    assert _out(e, {"answer": _digest(out)}) == ref["degrade/clean"]


@pytest.mark.parametrize("plan,name", SERVICE_CASES)
def test_run_stream_reports_device_query_fallbacks_as_the_reference(ref, plan, name):
    """run_stream's report queries on a sharded plan under faults at the
    engine.estimate site: the same fallbacks, counters and state."""
    from repro_torch.engine import ResilienceConfig, run_stream
    from repro_torch.engine.faults import parse_fault_plan

    e = _engine(plan, name)
    with fault_plan(parse_fault_plan(SERVICE_FAULTS)):
        rep = run_stream(e, batches(_planted(), S), report_every=1, on_report=_ignore,
                         resilience=ResilienceConfig(query_timeout_s=5.0))
    got = _out(e, {"report": _report(rep)})
    assert got["report"]["query_fallbacks"] == 2
    assert got == ref[f"service/{plan}"]


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_mesh_lines_match_jax_cli(ref, name):
    from repro_torch.launch import stream as cli

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(CLI_COMMON + CLI_CASES[name] + ["--device", "cpu"])
    got = _cli_lines(buf.getvalue())
    assert any(ln.startswith("mesh:") for ln in got)
    assert got == ref[f"cli/{name}"]


def test_cli_plans_golden_matches_port():
    """The golden chip_smoke.py's cli phase holds the card to: the JAX CLI's
    lines for a tenant-sharded bank on a 4-shard mesh, here on the CPU."""
    from repro_torch.launch import stream as cli

    gold = json.loads(PLANS_GOLDEN.read_text())
    assert gold["args"] == PLANS_ARGS
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(PLANS_ARGS + ["--device", "cpu"])
    got = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("mesh:", "estimate"))]
    assert got == gold["lines"]
    assert len(got) == 5  # the mesh line and four tenants' estimates


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_mesh_grammar_and_errors_match_reference(ref, spec):
    want = ref["mesh"]["errors"][spec]
    with pytest.raises(ValueError) as got:
        tmesh.make_stream_mesh(spec, "cpu", 8)
    assert str(got.value) == want
    m = tmesh.make_stream_mesh("tenants=2,estimators=4", "cpu", 8)
    assert (m.shape, list(tmesh.mesh_axes(m))) == (ref["mesh"]["shape"], ref["mesh"]["axes"])


@pytest.mark.parametrize("spec", ["tenants=2,estimators=2", "estimators=2,tenants=2",
                                  "tenants=4", "tenants=2"])
def test_layout_shards_are_contiguous_copies_that_gather_back(spec):
    """Each shard's block is a contiguous tensor of its own (the kernels
    take contiguous rows), in row-major shard order, and gathering the
    shards gives the full state back."""
    mesh = tmesh.make_stream_mesh(spec, "cpu", 8)
    layout = distributed.banked_state_sharding(mesh, "tenants", "global", r=12, n_tenants=4)
    g = torch.Generator().manual_seed(0)
    full = EstimatorState(torch.randint(-1, 9, (4, 12, 2), generator=g, dtype=torch.int32),
                          torch.randint(0, 9, (4, 12), generator=g, dtype=torch.int32),
                          torch.randint(-1, 9, (4, 12, 2), generator=g, dtype=torch.int32),
                          torch.rand((4, 12), generator=g) < 0.5, torch.arange(4) * 7)
    shards = layout.shard(full)
    for i, st in enumerate(shards):
        (t0, t1), (e0, e1) = layout.t_range(i), layout.e_range(i)
        for x, whole in zip(st, full):
            assert x.is_contiguous() and x.data_ptr() != whole.data_ptr()
            want = whole[t0:t1, e0:e1] if whole.dim() > 1 else whole[t0:t1]
            assert torch.equal(x, want)
    for x, whole in zip(layout.gather(shards, "cpu"), full):
        assert torch.equal(x, whole)


def test_mesh_without_host_devices_needs_that_many_devices():
    with pytest.raises(ValueError, match="--host-devices 4"):
        tmesh.make_stream_mesh("4", device="cpu")
    assert tmesh.make_stream_mesh("", device="cpu") is None
    assert tmesh.make_stream_mesh("1", device="cpu").devices == (torch.device("cpu"),)


def test_search_helpers_and_group_sums_match_reference():
    """composite_key, exact_multisearch (with valid_n), count_eq,
    predecessor_multisearch and the shardable group sums against the
    reference's primitives, on keys with runs, misses and padding."""
    import jax.numpy as jnp

    import repro  # noqa: F401  -- x64
    from repro.core.estimate import combine_group_sums as j_combine
    from repro.core.estimate import partial_group_sums as j_partial
    from repro.primitives import search as jsearch
    from repro.primitives.sort import composite_key as j_composite
    from repro_torch.core.estimate import combine_group_sums, partial_group_sums
    from repro_torch.primitives import search
    from repro_torch.primitives.sort import composite_key

    g = np.random.default_rng(8)
    keys = np.sort(np.concatenate([g.integers(0, 50, 60), [2**62] * 4])).astype(np.int64)
    q = np.concatenate([g.integers(-3, 55, 90), [2**62, 2**63 - 1]]).astype(np.int64)
    kt, qt = torch.from_numpy(keys), torch.from_numpy(q)
    for valid_n in (None, 60, 0):
        j, f = search.exact_multisearch(kt, qt, valid_n)
        wj, wf = jsearch.exact_multisearch(jnp.asarray(keys), jnp.asarray(q),
                                           None if valid_n is None else jnp.int64(valid_n))
        np.testing.assert_array_equal(j.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(f.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(search.count_eq(kt, qt).numpy(),
                                  np.asarray(jsearch.count_eq(jnp.asarray(keys), jnp.asarray(q))))
    np.testing.assert_array_equal(
        search.predecessor_multisearch(kt, qt).numpy(),
        np.asarray(jsearch.predecessor_multisearch(jnp.asarray(keys), jnp.asarray(q))))
    major, minor = g.integers(0, 2**31, 50), g.integers(0, 1000, 50)
    np.testing.assert_array_equal(
        composite_key(torch.from_numpy(major), torch.from_numpy(minor), 1000).numpy(),
        np.asarray(j_composite(jnp.asarray(major), jnp.asarray(minor), 1000)))
    x = (g.integers(0, 3, 600) * g.integers(0, 2**20, 600)).astype(np.float64)
    for r_split in ((0, 600), (0, 250, 600), (0, 66, 67, 400, 600)):
        parts = [partial_group_sums(torch.from_numpy(x[lo:hi]), lo, 600, 9)
                 for lo, hi in zip(r_split, r_split[1:])]
        want = [np.asarray(j_partial(jnp.asarray(x[lo:hi]), lo, 600, 9))
                for lo, hi in zip(r_split, r_split[1:])]
        for a, b in zip(parts, want):
            np.testing.assert_array_equal(a.numpy(), b)
        assert float(combine_group_sums(torch.stack(parts), 600, 9)) == float(
            j_combine(jnp.stack([jnp.asarray(w) for w in want]), 600, 9))


# ---------------------------------------------------------------------------
# draws at an estimator offset
# ---------------------------------------------------------------------------
SPLITS = [(0, 512), (0, 200, 512), (0, 1, 255, 256, 511, 512), (0, 100, 300, 512)]


def _chunk(seed, r, K, s):
    g = np.random.default_rng(seed)
    Ws = torch.from_numpy(g.integers(0, 60, size=(K, s, 2)).astype(np.int32))
    nv = torch.from_numpy(np.array([s] + list(g.integers(0, s + 1, K - 1)), np.int32))
    st = bulk.bulk_update_chunk(init_state(r), Ws, nv, rng.PRNGKey(seed), 0, backend="fused")
    st = st._replace(m_seen=torch.tensor(2**32 + 5, dtype=torch.int64))
    return st, Ws, nv


def _cut(st: EstimatorState, lo, hi, lead=0) -> EstimatorState:
    ix = (slice(None),) * lead + (slice(lo, hi),)
    return EstimatorState(*(x[ix] if x.dim() > lead else x for x in st))


@pytest.mark.parametrize("bounds", SPLITS)
def test_fused_ingest_plain_shards_concatenate_to_the_full_call(bounds):
    r, K, s = 512, 3, 40
    st, Ws, nv = _chunk(1, r, K, s)
    key = rng.PRNGKey(9)
    structs = bulk.chunk_structures(Ws, nv, use_kernels=False)
    full = fused_ingest_plain(*st[:4], *structs, Ws, nv, st.m_seen, key, 2**32 - 1)
    parts = [fused_ingest_plain(*_cut(st, lo, hi)[:4], *structs, Ws, nv, st.m_seen, key,
                                2**32 - 1, lo) for lo, hi in zip(bounds, bounds[1:])]
    for f, whole in enumerate(full):
        assert torch.equal(torch.cat([p[f] for p in parts]), whole)


@pytest.mark.parametrize("bounds", SPLITS)
def test_bulk_update_shards_concatenate_to_the_full_update(bounds):
    r, s, T = 512, 40, 2
    g = np.random.default_rng(4)
    W = torch.from_numpy(g.integers(0, 60, size=(T, s, 2)).astype(np.int32))
    keys = rng.fold_in(torch.stack([rng.PRNGKey(3), rng.PRNGKey(4)]), 7)
    st = init_state(r, n_tenants=T)
    st = bulk.bulk_update_all(st, W, s, keys)
    full = bulk.bulk_update_all(st, W, 31, rng.fold_in(keys, 1))
    parts = [bulk.bulk_update_all(_cut(st, lo, hi, 1), W, 31, rng.fold_in(keys, 1), e0=lo)
             for lo, hi in zip(bounds, bounds[1:])]
    for f in ("f1", "chi", "f2", "has_f3"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts], 1), getattr(full, f))
    Ws = W[:, None].expand(T, 3, s, 2).contiguous()
    nvs = torch.tensor([[s, 17, 0]] * T, dtype=torch.int32)
    full = bulk.bulk_update_chunk(st, Ws, nvs, keys, 5, backend="fused")
    for b in ("fused", "scan"):
        parts = [bulk.bulk_update_chunk(_cut(st, lo, hi, 1), Ws, nvs, keys, 5, backend=b, e0=lo)
                 for lo, hi in zip(bounds, bounds[1:])]
        for f in ("f1", "chi", "f2", "has_f3"):
            assert torch.equal(torch.cat([getattr(p, f) for p in parts], 1), getattr(full, f))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", SPLITS + [(0, 513, 1024, 1537)])
def test_cuda_fused_ingest_shards_concatenate_to_the_full_call(cuda, bounds):
    r, K, s = bounds[-1], 3, 600
    st, Ws, nv = _chunk(2, r, K, s)
    st = EstimatorState(*(x.to(cuda) for x in st))
    Ws, nv, key = Ws.to(cuda), nv.to(cuda), rng.PRNGKey(5, cuda)
    structs = rank_all_chunk(Ws, nv, use_kernels=True)
    structs = (structs.key_desc, structs.key_rank, structs.src, structs.dst, structs.pos,
               structs.ekey, structs.epos)
    full = fused_ingest(*st[:4], *structs, Ws, nv, st.m_seen, key, 7)
    for f, want in zip(full, fused_ingest_plain(*st[:4], *structs, Ws, nv, st.m_seen, key, 7)):
        assert torch.equal(f, want)
    for lo, hi in zip(bounds, bounds[1:]):
        sl = _cut(st, lo, hi)
        got = fused_ingest(*[x.contiguous() for x in sl[:4]], *structs, Ws, nv, st.m_seen,
                           key, 7, lo)
        plain = fused_ingest_plain(*sl[:4], *structs, Ws, nv, st.m_seen, key, 7, lo)
        for a, b, whole in zip(got, plain, full):
            assert torch.equal(a, b)
            assert torch.equal(a, whole[lo:hi])


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        _write_golden()
    else:
        _jax_side(sys.argv[1])
