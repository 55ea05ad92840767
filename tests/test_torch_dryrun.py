"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference's on the CPU.

* The CLI on one small cell (the twin of ``tests/test_drivers.py``'s
  ``test_dryrun_single_cell_cli``), and ``roofline.tables`` rendering it.
* gat-cora ``molecule`` and bert4rec ``serve_p99`` on both production
  meshes against one reference dry run a cell in a subprocess (JAX fixes
  its device count at its first init, and the reference's mesh needs 512):
  ``chips``, ``model_flops`` and ``cost.flops_analytic_total`` equal, and
  ``memory.argument_bytes`` equal to XLA's count of every argument up to the
  key's dtype. XLA's record leaves out the arguments the step never reads
  (``jit``'s ``keep_unused=False``), so the subprocess adds their bytes from
  the reference's own lowering (``kept_var_idx``).
* ``roofline/collectives.py``'s ring formulas against
  ``repro.roofline.hlo.collective_stats`` on a hand-written HLO line of each
  kind; the rules that derive a model cell's collectives on smoke LM cells.
* A stream update on a ``meta`` mesh of 4 shards records exactly the
  collectives its plan calls; recording leaves a CPU plan's bits alone.
* ``kernels/ref.py::delete_hits_ref`` against the reference's oracle and
  the plain deletion search; ``count.record`` refuses ``meta`` arguments.
* The layer-count fit of an LM prefill or decode cell
  (``dryrun.model_counts``) against a whole trace at smoke width and 6
  layers, every count equal, and train cells traced whole; the live-storage
  counter (``count.LiveBytes``) on a function of known peak, on autograd's
  saved tensors, and equal on ``meta`` and the CPU; ``count.StepCounter``
  against ``FlopCounterMode``, ``ByteCounter`` and ``LiveBytes`` stacked;
  a train step's bytes quadratic in the layers.

No test here traces a full-width LM cell (the smallest takes minutes on
``meta``).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: E402,F401  -- enables x64, as the reference's CLIs run
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.roofline import hlo as jhlo  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import cells  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.schemes import GlobalScheme  # noqa: E402
from repro_torch.core.state import EstimatorState  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.multisearch import multisearch_counts_plain  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.roofline import collectives, count, tables  # noqa: E402
from repro_torch.roofline.collectives import Collective  # noqa: E402
from repro_torch.train.sharding import (P, local_bytes, local_shape, spec_axes,  # noqa: E402
                                        spec_leaves)

REF_CELLS = [("gat-cora", "molecule"), ("bert4rec", "serve_p99")]

# one reference dry run of a cell on both meshes, with the bytes of the
# arguments its jit leaves out
_REF_DRIVER = r"""
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import cells
from repro.launch import dryrun as d
from repro.launch.mesh import make_production_mesh

arch, shape, out = sys.argv[1:4]
recs = {}
for mp in (False, True):
    rec = d.run_model_cell(arch, shape, mp)
    mesh = make_production_mesh(multi_pod=mp)
    cell = cells.build_cell(arch, shape, tuple(mesh.axis_names))
    in_sh = d._shard(mesh, cell.in_specs, cell.args)
    with d._ambient_mesh(mesh):
        lowered = jax.jit(cell.fn, in_shardings=in_sh).lower(*cell.args)
    kept = set(lowered._lowering.compile_args["kept_var_idx"])
    pairs = zip(jax.tree.leaves(cell.args), jax.tree.leaves(in_sh))
    rec["dropped_argument_bytes"] = sum(
        math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize
        for i, (a, sh) in enumerate(pairs) if i not in kept)
    recs[rec["mesh"]] = rec
open(out, "w").write(json.dumps(recs))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records of REF_CELLS, one subprocess a cell, run at once."""
    d = tmp_path_factory.mktemp("ref_dryrun")
    procs = {}
    for arch, shape in REF_CELLS:
        out = d / f"{arch}__{shape}.json"
        procs[(arch, shape)] = (out, subprocess.Popen(
            [sys.executable, "-c", _REF_DRIVER, arch, shape, str(out)], env=_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    recs = {}
    for cell, (out, p) in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        recs[cell] = json.loads(out.read_text())
    return recs


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_dryrun")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gat-cora",
                        "--shape", "molecule", "--out-dir", str(d)], env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return d


def test_dryrun_single_cell_cli(cli_dir):
    """The dry-run CLI works end to end for one small cell (256 ranks)."""
    rec = json.loads((cli_dir / "gat-cora__molecule__pod.json").read_text())
    assert rec["ok"] and rec["chips"] == 256
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["source"] == "derived"
    assert rec["collectives"]["rules"] == ["a"] and rec["collectives"]["wire_bytes_total"] > 0


def test_all_runs_every_cell_on_both_meshes(tmp_path, monkeypatch, capsys):
    """--all: one subprocess a cell and mesh, --jobs at once; a cell past
    --timeout is written ok: false and the run exits 1; a rerun redoes it,
    and one after that skips the cells with an ok record."""
    monkeypatch.setattr(dryrun.cells, "all_cells", lambda: [("bert4rec", "serve_p99")])
    monkeypatch.setattr(dryrun, "STREAM_SHAPES", {})
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    tags = ["bert4rec__serve_p99__pod", "bert4rec__serve_p99__multipod"]
    assert dryrun._run_all(tmp_path, timeout=0.01, jobs=2) == 1
    for tag in tags:
        rec = json.loads((tmp_path / f"{tag}.json").read_text())
        assert not rec["ok"] and "timed out" in rec["error"]
    assert dryrun._run_all(tmp_path, timeout=600, jobs=2) == 0
    chips = [json.loads((tmp_path / f"{t}.json").read_text())["chips"] for t in tags]
    assert chips == [256, 512]
    capsys.readouterr()
    assert dryrun._run_all(tmp_path, timeout=600, jobs=2) == 0
    assert capsys.readouterr().out.count("[skip]") == 2


def test_tables_render_dryrun_records(cli_dir, capsys):
    tables.main(["--dir", str(cli_dir), "--mesh", "pod"])
    rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("| gat-cora")]
    assert len(rows) == 1 and "| molecule |" in rows[0]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", REF_CELLS)
def test_model_cell_matches_reference(reference, arch, shape, multi_pod):
    want = reference[(arch, shape)]["multipod" if multi_pod else "pod"]
    got = dryrun.run_model_cell(arch, shape, multi_pod)
    for k in ("chips", "model_flops", "arch", "shape", "mesh"):
        assert got[k] == want[k], k
    assert got["cost"]["flops_analytic_total"] == want["cost"]["flops_analytic_total"]
    # XLA counts a uint32 (2,) key where the port has int64 (2,); a step's
    # key is its last argument
    key_extra = 8 if isinstance(cells.build_cell(arch, shape).args[-1], torch.Tensor) else 0
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] + want["dropped_argument_bytes"] + key_extra
    # temp_bytes: the live-storage counter's over the whole step, per rank
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = cells.build_cell(arch, shape, tuple(mesh.axis_names))
    _, n = count.count_step(cell.fn, cell.args)
    assert got["memory"]["temp_bytes"] > 0
    assert got["memory"]["temp_bytes"] == -(-n.temp_bytes // mesh.size)
    assert got["memory"]["alias_bytes"] == 0 and got["layer_fit"] is None
    assert got["cost"]["flops"] > 0 and got["hlo_size"] > 0


def test_production_mesh_is_meta():
    for mp, shape, axes in [(False, (16, 16), ("data", "model")),
                            (True, (2, 16, 16), ("pod", "data", "model"))]:
        mesh = make_production_mesh(multi_pod=mp)
        assert mesh.axis_names == axes and tuple(mesh.shape.values()) == shape
        assert mesh.size == math.prod(shape)
        assert {d.type for d in mesh.devices} == {"meta"}


_HLO = {
    "all-gather": ("%ag = f32[16,128]{1,0} all-gather(f32[1,128]{1,0} %p), "
                   "replica_groups=[16,16]<=[256], dimensions={0}", 16 * 128 * 4, 16),
    "reduce-scatter": ("%rs = bf16[8]{0} reduce-scatter(bf16[128]{0} %x), "
                       "replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add", 8 * 2, 4),
    "all-reduce": ("%ar = bf16[4,4096,576]{2,1,0} all-reduce(bf16[4,4096,576]{2,1,0} %h), "
                   "replica_groups=[32,16]<=[512], to_apply=%add", 4 * 4096 * 576 * 2, 16),
    "all-to-all": ("%aa = s32[1024,3]{1,0} all-to-all(s32[1024,3]{1,0} %b), "
                   "replica_groups=[1,256]<=[256], dimensions={0}", 1024 * 3 * 4, 256),
    "collective-permute": ("%cp = f32[32]{0} collective-permute(f32[32]{0} %x), "
                           "source_target_pairs={{0,1},{1,0}}", 32 * 4, 2),
}


@pytest.mark.parametrize("kind", list(_HLO))
def test_ring_formulas_match_hlo(kind):
    line, nbytes, group = _HLO[kind]
    assert collectives.collective_stats([Collective(kind, nbytes, group)]) == \
        jhlo.collective_stats(line)


def _smoke_lm(arch_shape=("smollm-135m", "train_4k"), multi_pod=False, **overrides):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(axes, (2, 16, 16) if multi_pod else (16, 16)))
    return cells.build_cell(*arch_shape, axes, smoke=True, overrides=overrides or None), sizes


def test_local_bytes_ceil_divides_each_sharded_dimension():
    sizes = {"pod": 2, "data": 16, "model": 16}
    t = torch.empty((256, 10, 7), dtype=torch.bfloat16, device="meta")
    assert local_shape(t.shape, P(("pod", "data"), "model"), sizes) == (8, 1, 7)
    assert local_shape(t.shape, P(), sizes) == (256, 10, 7)
    assert local_bytes(t, P(None, None, "data"), sizes) == 256 * 10 * 1 * 2


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_derived_rules_on_a_train_cell(multi_pod):
    """(a) every parameter's gradient over the batch axes (no leaf is
    sharded over them without fsdp), then (c) wo and wd a layer, forward,
    backward and recompute, for each of 2 micro-batches."""
    cell, sizes = _smoke_lm(multi_pod=multi_pod, remat=True, grad_accum=2)
    calls, rules = collectives.derive(cell, sizes)
    assert rules == ["a", "c"]
    bg = 32 if multi_pod else 16
    grads = [Collective("all-reduce", local_bytes(t, sp, sizes), bg)
             for t, sp in spec_leaves(cell.args[0], cell.in_specs[0])]
    cfg = cell.config
    b_local = -(-4 // bg)  # the smoke batch of 4 over the batch axes
    act = -(-b_local // 2) * 16 * cfg.d_model * cfg.dtype.itemsize
    assert calls == grads + [Collective("all-reduce", act, 16)] * (cfg.n_layers * 2 * 3 * 2)


def test_derived_rules_fsdp_and_decode():
    cell, sizes = _smoke_lm(fsdp_params=True)
    calls, rules = collectives.derive(cell, sizes)
    assert rules == ["b", "a", "c"]
    pairs = list(spec_leaves(cell.args[0], cell.in_specs[0]))
    want = []
    for t, sp in pairs:
        local = local_bytes(t, sp, sizes)
        if "data" in spec_axes(sp):
            want += [Collective("all-gather", 16 * local, 16),
                     Collective("reduce-scatter", local, 16)]
        else:
            want.append(Collective("all-reduce", local, 16))
    assert any(c.kind == "all-gather" for c in want)
    assert calls[:len(want)] == want
    dec, sizes = _smoke_lm(("smollm-135m", "decode_32k"))
    calls, rules = collectives.derive(dec, sizes)
    assert rules == ["c"]
    assert calls == [Collective("all-reduce", 1 * 1 * dec.config.d_model * 2, 16)] * \
        (dec.config.n_layers * 2)


def _meta_stream(r, s):
    def E(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return (EstimatorState(E((r, 2), torch.int32), E((r,), torch.int32), E((r, 2), torch.int32),
                           E((r,), torch.bool), E((), torch.int64)),
            E((s, 2), torch.int32), E((2,), torch.int64))


def _expected_shardmap(p, r, s, cf=2.0):
    """The collectives make_coordinated_update calls: the arcs' and edges'
    all_to_all (rows of 3 int32 and a valid column), then four routed
    lookups of 3 all_to_alls each (the payload, its valid flags, the
    answers), then the overflow's psum."""
    s_l, r_l = s // p, r // p
    cap_a = max(int(2 * s_l * cf / p), 8)
    cap_e = max(int(s_l * cf / p), 8)
    q = p * max(int(2 * r_l * cf / p), 8) * 4  # bytes of one int32 column of a routed buffer
    a2a = [p * cap_a * 16, p * cap_e * 16]
    for payload, answer in [(1, 2), (2, 1), (2, 3), (2, 1)]:  # fetch, rank, decode, close
        a2a += [q * payload, q, q * answer]
    return [Collective("all-to-all", b, p) for b in a2a] + [Collective("all-reduce", 8, p)]


@pytest.mark.parametrize("w_mode", ["coordinated_xla", "independent", "shardmap"])
def test_stream_update_records_its_plan_collectives(w_mode):
    p, r, s = 4, 1024, 512
    mesh = Mesh((2, 2), ("data", "model"), [torch.device("meta")] * p)
    state, W, key = _meta_stream(r, s)
    if w_mode == "shardmap":
        update = dist.make_coordinated_update(mesh, r=r, s=s)
        want = _expected_shardmap(p, r, s)
    else:
        update = dist.make_pjit_update(mesh, w_mode, r=r)
        want = [] if w_mode == "independent" else [Collective("all-gather", s * 2 * 4, p)]
    sharded = dist.ShardedState(update.layout.shard(state), update.layout)
    plain = (dist._all_to_all, dist._all_gather, dist._psum)
    with collectives.recording() as calls, FlopCounterMode(display=False) as flops:
        update(sharded, W, s, key)
    assert calls == want
    assert flops.get_total_flops() == 0  # why the dry run counts no flops on a plan
    assert (dist._all_to_all, dist._all_gather, dist._psum) == plain  # restored on exit


def test_recording_leaves_plan_bits_alone():
    p, r, s = 4, 256, 128
    mesh = make_test_mesh((2, 2), ("data", "model"), host_devices=4)
    g = np.random.default_rng(0)
    W = torch.from_numpy(g.integers(0, 40, (s, 2)).astype(np.int32))
    update = dist.make_coordinated_update(mesh, r=r, s=s)
    full = GlobalScheme().init_state(r, "cpu")
    key = rng.PRNGKey(3, "cpu")

    def run():
        st = dist.ShardedState(update.layout.shard(full), update.layout)
        out, ovf = update(st, W, s - 5, key)
        return out.gather("cpu"), ovf

    plain, ovf_plain = run()
    with collectives.recording() as calls:
        recorded, ovf_rec = run()
    assert len(calls) == 15
    assert all(torch.equal(a, b) for a, b in zip(plain, recorded))
    assert torch.equal(ovf_plain, ovf_rec)


def test_delete_hits_ref_matches_reference():
    g = np.random.default_rng(7)
    n, q = 1000, 5000
    keys = np.sort(g.integers(0, 3000, n).astype(np.int64))
    keys[-100:] = np.iinfo(np.int64).max  # a ragged batch's padding
    queries = np.concatenate([g.integers(0, 3000, q - 3), [-1, np.iinfo(np.int64).max, 0]])
    queries = queries.astype(np.int64)
    got = tref.delete_hits_ref(torch.from_numpy(keys), torch.from_numpy(queries))
    want = np.asarray(jref.delete_hits_ref(jnp.asarray(keys), jnp.asarray(queries)))
    assert np.array_equal(got.numpy(), want) and want.any() and not want.all()
    lt, le = multisearch_counts_plain(torch.from_numpy(keys), torch.from_numpy(queries))
    assert torch.equal(le > lt, got)
    assert "delete_hits_ref" in tref.__all__


def test_record_refuses_meta():
    cell = cells.build_cell("gat-cora", "molecule", smoke=True)
    with pytest.raises(ValueError, match="meta"):
        count.record(cell, cell.args, smoke=True)


# the steps the dry run fits: prefill and decode of every LM arch
FIT_CASES = [(a, s) for a in cells.LM_ARCHS for s in ("prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FIT_CASES)
def test_layer_fit_equals_the_whole_trace(arch, shape):
    """At smoke width on the pod mesh with 6 layers, the counts fitted from
    2, 3 and 4 layers equal a trace of all 6: flops, bytes, aten ops, the
    live-storage peak, the new outputs' bytes, per-rank output and alias
    bytes."""
    mesh = make_production_mesh()
    axes = tuple(mesh.axis_names)
    cell, fitted, layers = dryrun.model_counts(arch, shape, axes, mesh.shape, {"n_layers": 6},
                                               smoke=True)
    whole = dryrun._trace(cells.build_cell(arch, shape, axes, smoke=True,
                                           overrides={"n_layers": 6}), mesh.shape)
    assert layers == [2, 3, 4] and cell.config.n_layers == 6
    assert fitted == whole
    assert whole["peak"] > whole["new_out_bytes"] > 0 and whole["ops"] > 0


@pytest.mark.parametrize("arch", cells.LM_ARCHS)
def test_train_cells_are_traced_whole(arch):
    """A train step is not fitted (its peak moves between the forward, the
    loss and the backward as layers are added): at 6 layers its counts are
    one whole trace's."""
    mesh = make_production_mesh()
    axes = tuple(mesh.axis_names)
    cell, counts, layers = dryrun.model_counts(arch, "train_4k", axes, mesh.shape,
                                               {"n_layers": 6}, smoke=True)
    assert layers is None and not dryrun.fits_layers(cell) and cell.config.n_layers == 6
    assert counts == dryrun._trace(cell, mesh.shape)


def test_fit_at_is_exact_in_integers():
    big = 2**60 + 1  # past float64's integers
    assert dryrun.fit_at((2, 3, 4), [big + 5, big + 11, big + 19], 61) == \
        big + 5 + 6 * 59 + 59 * 58
    assert dryrun.fit_at((2, 3, 4), [4, 9, 16], 30) == 900
    with pytest.raises(ValueError):
        dryrun.fit_at((0, 2), [0, 1], 1)


def test_live_bytes_of_a_function_of_known_peak():
    """A result adds its storage once; a view, an in-place op and an
    argument add nothing; a freed result comes off: peak 12,000 bytes."""
    x = torch.ones(1000)

    def f(x):
        a = x * 2  # 4,000
        b = a.view(10, 100)  # a view: nothing
        a.add_(1)  # in place: nothing
        y = x[:10]  # a view of the argument: nothing
        c = torch.cat([a, a])  # 8,000: live 12,000, the peak
        del a, b  # frees a: 8,000
        return c.sum() + y.sum()  # 3 scalars (live 8,012); c is freed on return

    for dev in ("cpu", "meta"):
        out, n = count.count_step(f, (x.to(dev),))
        assert (n.peak, n.new_out_bytes, n.temp_bytes) == (12_000, 4, 11_996), dev


def test_live_bytes_keeps_autograd_saved_tensors():
    """exp saves its result for the backward: while the graph holds it,
    its storage stays live; without grad it is freed with the sum."""
    w = torch.ones(1000, requires_grad=True)

    def f(w):
        return (w * 3).exp().sum()

    for grad, live_after in [(True, 4004), (False, 4)]:
        with torch.set_grad_enabled(grad), count.LiveBytes([w]) as live:
            loss = f(w)
        assert live.peak == 8000 and live.live == live_after, grad
        del loss
        assert live.live == 0


def test_live_peak_equal_on_meta_and_cpu():
    cell = cells.build_cell("smollm-135m", "train_4k", smoke=True)
    _, cpu = count.count_step(cell.fn, count.materialize(cell, "cpu"))
    _, meta = count.count_step(cell.fn, count.materialize(cell, "meta"))
    assert cpu == meta and cpu.peak > cpu.new_out_bytes > 0


@pytest.mark.parametrize("arch,shape", [("granite-moe-1b-a400m", "train_4k"),
                                        ("gat-cora", "molecule"), ("bert4rec", "train_batch")])
def test_step_counter_equals_the_stacked_modes(arch, shape):
    """One ``StepCounter`` (and, on ``meta``, its reused shapes) counts
    what ``FlopCounterMode``, ``ByteCounter`` and ``LiveBytes`` stacked
    count, on the CPU and on ``meta``."""
    cell = cells.build_cell(arch, shape, smoke=True)
    for dev in ("cpu", "meta"):
        args = count.materialize(cell, dev)
        held = count._leaves(args)
        with FlopCounterMode(display=False) as fc, count.ByteCounter() as moved, \
                count.LiveBytes(held) as live:
            out = cell.fn(*args)
        keys = {t.untyped_storage()._cdata for t in held}
        new = count._storage_bytes([t for t in count._leaves(out)
                                    if t.untyped_storage()._cdata not in keys])
        want = count.StepCount(fc.get_total_flops(), moved.bytes, moved.ops, live.peak, new)
        _, got = count.count_step(cell.fn, args)
        assert got == want, dev


@pytest.mark.parametrize("arch,d2", [("smollm-135m", 321_024), ("granite-moe-1b-a400m", 250_880),
                                     ("kimi-k2-1t-a32b", 1_099_776)])
def test_train_bytes_grow_with_the_square_of_the_layers(arch, d2):
    """A train step's counted bytes have a constant second difference in
    the layer count (about one stacked gradient a layer, ROADMAP A.21);
    its flops and aten ops are affine. Smoke width, pod mesh."""
    mesh = make_production_mesh()
    t = [dryrun._trace(cells.build_cell(arch, "train_4k", tuple(mesh.axis_names), smoke=True,
                                        overrides={"n_layers": n}), mesh.shape)
         for n in dryrun.FIT_LAYERS]
    second = {k: t[2][k] - 2 * t[1][k] + t[0][k] for k in ("bytes", "flops", "ops")}
    assert second == {"bytes": d2, "flops": 0, "ops": 0}
