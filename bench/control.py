"""The control of the comparison that decides ``correct``: the reference in
the precision one step below the configuration's (the level-2 coin's
threshold in bfloat16, estimates in float32), put in the program's place
for the first job of a run, and compared as a run's checked job is.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Prints one JSON line per seed with each compared number beside its limit;
the control has to fail at least one of them. The benchmark's own runs do
not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_job(cfg: dict, graphs, seeds: tuple, device, steps: list):
    """A job whose answers and final state come from the low-precision
    reference."""
    import numpy as np
    import torch

    from bench.harness import Job
    from bench.reference import nbsi
    from bench.traffic.generator import n_batches

    per_step: dict = {}
    states: list = []

    def on_answer(t, step, ans):
        ans = ans.cpu() if isinstance(ans, torch.Tensor) else ans
        per_step.setdefault(step, []).append(np.asarray(ans, np.float64))

    def on_state(t, st):
        states.append(st)

    nbsi.replay(list(graphs), list(seeds), cfg, cfg["batch_size"],
                n_batches(graphs.shape[1], cfg["batch_size"]), steps, device,
                on_answer=on_answer, on_state=on_state, low=True)
    job = Job(seeds)
    job.answers = [(step, 0.0, np.stack(per_step[step])) for step in steps]
    job.state = {"f1": torch.stack([s.f1.cpu() for s in states]),
                 "chi": torch.stack([s.chi.cpu() for s in states]),
                 "f2": torch.stack([s.f2.cpu() for s in states]),
                 "has_f3": torch.stack([s.has_f3.cpu() for s in states]),
                 "m_seen": torch.tensor([s.m for s in states])}
    return job


def readings(cell_name: str, seed: int, device: str, root: Path = ROOT,
             overrides=None) -> dict:
    import torch

    from bench import harness
    from bench.reference import compare
    from bench.traffic.generator import job_graphs, n_batches

    _, cfg, traffic = harness.cell_settings(root, cell_name, overrides)
    dev = torch.device(device)
    graphs, _ = job_graphs(traffic, cfg["n_tenants"], seed, dev)
    nb = n_batches(graphs.shape[1], cfg["batch_size"])
    steps = harness.expected_steps(nb, cfg["chunk_size"], traffic["report_every"])
    seeds = harness.job_seeds(seed, 0, cfg["n_tenants"])
    t0 = time.perf_counter()
    job = control_job(cfg, graphs, seeds, dev, steps)
    checks = compare.check_job(job, graphs, cfg, traffic, nb, dev, expected=steps, lost=0)
    return {"workload": cell_name, "seed": seed, "seconds": time.perf_counter() - t0,
            "failed_checks": [k for k, c in checks.items() if c["value"] > c["limit"]],
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
