"""The comparison that decides ``correct``: one job of the window, drawn
from the seed, against the reference's replay of the same job.

The numbers compared, each with the limit the configuration file sets
(``check_limits``):

  batches_lost     batches of the window not ingested exactly once
                   (quarantined, stood in for, redelivered); the
                   configurations guarantee every batch once, in order
  answers_missing  answers due in the checked job (a report after each
                   ingest call at a multiple of ``report_every``, and the
                   final estimate) that never came, or came for another step
  state_mismatch   estimator slots (f1, chi, f2, has_f3) of any tenant that
                   differ from the reference's after the job, plus tenants
                   whose stream length differs
  answer_gap       the widest gap between an answer and the reference's at
                   the same step, element by element, over the larger of the
                   reference's magnitude there and 1
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from bench.reference import nbsi


def _gap(prog, ref) -> float:
    """The widest gap between two answers, each element's over the larger of
    the reference's magnitude there and 1 (a count)."""
    q = torch.as_tensor(ref, dtype=torch.float64)
    p = torch.as_tensor(np.asarray(prog, np.float64)).to(q.device)
    if p.shape != q.shape or not bool(torch.isfinite(p).all()):
        return float("inf")
    if p.numel() == 0:
        return 0.0
    return float(((p - q).abs() / q.abs().clamp(min=1.0)).max())


def _mismatch(prog: dict, t: int, st: nbsi.State) -> int:
    f1 = prog["f1"][t] != st.f1.cpu()
    f2 = prog["f2"][t] != st.f2.cpu()
    slots = f1.any(-1) | (prog["chi"][t] != st.chi.cpu()) | f2.any(-1) \
        | (prog["has_f3"][t] != st.has_f3.cpu())
    return int(slots.sum()) + int(int(prog["m_seen"].reshape(-1)[t]) != st.m)


def check_job(job, graphs: np.ndarray, cfg: dict, traffic: dict, n_batches: int, device, *,
              expected: list, lost: int) -> dict:
    """The checked job's numbers against the reference, each with its limit
    (see the module docstring)."""
    limits = cfg["check_limits"]
    got = Counter(step for step, _, _ in job.answers)
    missing = sum(((Counter(expected) - got) + (got - Counter(expected))).values())
    answers = {step: value for step, _, value in job.answers}
    worst = {"gap": 0.0, "state": 0}

    def on_answer(t, step, ref):
        if step in answers:
            worst["gap"] = max(worst["gap"], _gap(np.asarray(answers[step])[t], ref))

    def on_state(t, st):
        worst["state"] += _mismatch(job.state, t, st)

    nbsi.replay(list(graphs), list(job.seeds), cfg, cfg["batch_size"], n_batches,
                sorted(set(expected)), device, on_answer=on_answer, on_state=on_state)
    values = {"batches_lost": lost, "answers_missing": missing,
              "state_mismatch": worst["state"], "answer_gap": worst["gap"]}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
