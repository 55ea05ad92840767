"""The port's roofline (``repro_torch.roofline``) against the JAX reference
on the CPU: the analytic FLOP formulas (equal floats: the same expressions
in the same order), the three-term roofline and its table (equal, with the
reference's TPU constants set to the port's H100 ones inside the test), the
reference's bound-detection case on the H100's constants, and the one-card
record of ``roofline/count.py`` and its byte count.

The reference holds its formula to XLA's HLO count within 15% on a
scan-free probe (``tests/test_roofline.py``); the port counts the eager step
op by op with ``FlopCounterMode`` and holds the same probe exactly.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: E402,F401  -- enables x64, as the reference's CLIs run
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import cells as jcells  # noqa: E402
from repro.roofline import flops as jflops  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro.roofline import tables as jtables  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import cells  # noqa: E402
from repro_torch.roofline import count, flops, report, tables  # noqa: E402


def _full(mod_table, arch):
    import importlib

    return importlib.import_module(mod_table[arch][0]).FULL


@pytest.mark.parametrize("arch", list(cells.LM_ARCHS))
def test_lm_flops_match_jax(arch):
    jcfg, tcfg = _full(jcells.LM_ARCHS, arch), _full(cells.LM_ARCHS, arch)
    for kind in ("train", "prefill", "decode"):
        for B, S in [(1, 1), (4, 128), (256, 4096), (3, 524288)]:
            assert flops.lm_flops(tcfg, kind, B, S) == jflops.lm_flops(jcfg, kind, B, S)


def test_recsys_and_stream_flops_match_jax():
    import repro.configs.bert4rec as jb
    import repro_torch.configs.bert4rec as tb

    for jcfg, tcfg in [(jb.FULL, tb.FULL), (jb.SMOKE, tb.SMOKE)]:
        for kind in ("train", "score"):
            for B, C, n_neg in [(1, 0, 1023), (512, 1024, 1023), (4, 64, 7), (262144, 1024, 0)]:
                assert flops.recsys_flops(tcfg, kind, B, C, n_neg) == \
                    jflops.recsys_flops(jcfg, kind, B, C, n_neg)
    for r in (1, 3, 2**21):
        for s in (0, 1, 2, 1000, 2**20):
            for scheme in ("global", "independent"):
                assert flops.stream_flops(r, s, scheme) == jflops.stream_flops(r, s, scheme)


def test_flop_counter_equals_the_formula_on_the_scan_free_probe():
    """The reference's probe (L = 1, S = one chunk, all-position logits):
    FlopCounterMode around the port's forward and logits counts exactly the
    analytic formula, 243,269,632 FLOPs."""
    from repro_torch.models.transformer import TransformerConfig, forward, init_params, logits_fn

    cfg = TransformerConfig(name="probe", n_layers=1, d_model=256, n_heads=4, n_kv_heads=4,
                            d_ff=512, vocab=1024, chunk_q=64, chunk_k=64, dtype=torch.float32)
    B, S = 2, 64
    params = init_params(rng.PRNGKey(0), cfg)
    toks = torch.zeros((B, S), dtype=torch.int32)
    with FlopCounterMode(display=False) as counter:
        h, _ = forward(params, cfg, toks)
        logits_fn(params, cfg, h)
    analytic = flops.lm_flops(cfg, "prefill", B, S) + (
        2 * B * S * cfg.d_model * cfg.vocab - 2 * B * cfg.d_model * cfg.vocab)
    assert counter.get_total_flops() == analytic == 243_269_632


def _records():
    base = {"arch": "qwen3-4b", "shape": "train_4k", "chips": 256,
            "memory": {"argument_bytes": 3e9, "output_bytes": 2e9, "temp_bytes": 7e9,
                       "alias_bytes": 0}}
    out = []
    for flops_, bytes_, wire, analytic, mf in [
            (1e12, 1e9, 1e6, None, 0.5e12 * 256), (1e9, 1e12, 1e6, 4e12, 1e11),
            (1e6, 1e6, 1e12, 2e9, 0.0), (0.0, 0.0, 0.0, None, 0.0), (3.3e14, 2.2e11, 5e9, 9e16, 8e16)]:
        out.append(base | {"cost": {"flops": flops_, "bytes_accessed": bytes_,
                                    "flops_analytic_total": analytic},
                           "collectives": {"wire_bytes_total": wire}, "model_flops": mf})
    return out


def test_roofline_terms_and_table_match_jax(monkeypatch):
    monkeypatch.setattr(jreport, "PEAK_FLOPS", report.PEAK_FLOPS)
    monkeypatch.setattr(jreport, "HBM_BW", report.HBM_BW)
    monkeypatch.setattr(jreport, "ICI_BW", report.NVLINK_BW)
    recs = _records()
    for r in recs:
        assert report.roofline_terms(r) == jreport.roofline_terms(r)
        assert tables.effective_flops(r) == jtables.effective_flops(r)
    for use in (True, False):
        assert tables.table(recs, use) == jtables.table(recs, use)
    for x in (0, 3e-10, 4e-7, 2e-4, 0.5, 7.0):
        assert tables.fmt_s(x) == jtables.fmt_s(x)
    for x in (0, 12, 4e3, 5e6, 6e9, 7e12):
        assert tables.fmt_b(x) == jtables.fmt_b(x)


def test_bound_detection_on_the_h100_constants():
    """The reference's case (tests/test_roofline.py), on the port's constants."""
    rec = {
        "cost": {"flops": 1e12, "bytes_accessed": 1e9},
        "collectives": {"wire_bytes_total": 1e6},
        "chips": 256,
        "model_flops": 0.5e12 * 256,
    }
    t = report.roofline_terms(rec)
    assert t["bound"] == "compute"
    assert t["compute_s"] == pytest.approx(1e12 / 989e12)
    assert 0 < t["roofline_fraction"] <= 1.0
    mem = report.roofline_terms(rec | {"cost": {"flops": 1e9, "bytes_accessed": 1e12}})
    assert mem["bound"] == "memory" and mem["memory_s"] == pytest.approx(1e12 / 3.35e12)
    wire = report.roofline_terms(rec | {"collectives": {"wire_bytes_total": 1e13}})
    assert wire["bound"] == "collective" and wire["collective_s"] == pytest.approx(1e13 / 450e9)


def test_byte_counter_counts_operands_and_results_once_and_skips_views():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    bias = torch.ones(4).expand(8, 4)  # stride 0: its 4 distinct floats
    table, rows = torch.ones(1000, 16), torch.tensor([3, 1, 999])
    x = torch.ones(2, 4, 16)  # a (B, S, d) operand
    with count.ByteCounter() as moved:
        c = a @ b
        _ = a.T  # a view: no traffic
        _ = c + bias
        _ = a * a  # one operand, counted once
        _ = table[rows]  # a gather reads the 3 rows it returns, not the table
        _ = x @ b  # view, mm, _unsafe_view: the mm's traffic only
        _ = x.transpose(1, 2).reshape(-1)  # transpose, clone, _unsafe_view: the clone's
        _ = torch.empty_like(x), x.new_empty(9), torch.empty(5)  # allocations: nothing
        z = torch.zeros_like(x)  # writes its result, reads nothing
        z.copy_(x)  # reads x, writes z
    assert moved.ops == 8
    assert moved.bytes == 4 * ((8 * 16 + 16 * 4 + 8 * 4) + (8 * 4 + 4 + 8 * 4) + 2 * 8 * 16
                               + 2 * 3 * 16 + (8 * 16 + 16 * 4 + 8 * 4) + 2 * 2 * 4 * 16
                               + 2 * 4 * 16 + 2 * 2 * 4 * 16) + 3 * 8


def test_record_of_a_smoke_step_and_its_table(tmp_path, capsys):
    cell = cells.build_cell("smollm-135m", "train_4k", smoke=True)
    rec = count.record(cell, count.materialize(cell, "cpu"), smoke=True)
    assert (rec["chips"], rec["mesh"], rec["ok"], rec["batch_scale"]) == (1, "card", True, 1.0)
    assert rec["cost"]["flops_analytic_total"] is None  # smoke shapes: the count stands
    assert rec["cost"]["flops"] > cell.model_flops > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["collectives"]["wire_bytes_total"] == 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["output_bytes"] > 0
    cut = count.record(cell, count.materialize(cell, "cpu", batch=2), smoke=True)
    assert cut["batch_scale"] == 0.5 and cut["model_flops"] == cell.model_flops / 2
    assert cut["cost"]["flops"] < rec["cost"]["flops"]
    full = cells.build_cell("smollm-135m", "train_4k")
    assert count.batch_scale(full, count.materialize(cell, "cpu", batch=2)) == 2 / 256
    # a decode record, written as chip_smoke.py writes it; the table loads
    # it, keeping its floor
    dec = cells.build_cell("smollm-135m", "decode_32k", smoke=True)
    written = count.record(dec, count.materialize(dec, "cpu", batch=2), smoke=True)
    assert written["batch_scale"] == 0.5 and written["memory"]["alias_bytes"] > 0
    (tmp_path / "smollm-135m__decode_32k__card.json").write_text(json.dumps(written))
    (loaded,) = tables.load(str(tmp_path), "card")
    assert loaded["model_flops"] == written["model_flops"]
    assert tables.load(str(tmp_path), "pod") == []
    capsys.readouterr()
    tables.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| smollm-135m | decode_32k |" in out and "**memory**" in out
