"""Train the full smollm-135m config for a few hundred steps on synthetic
structured text (``examples/train_lm.py``). Thin wrapper over the
training CLI, ``python -m repro_torch.launch.train``.

  python -m repro_torch.launch.train_lm                     # full 135M params, on the card
  python -m repro_torch.launch.train_lm --smoke --device cpu --ckpt-dir build/lm_ckpt

The caller's arguments follow ``ARGS``, so a repeated flag (``--steps``)
overrides the wrapper's. Training runs on the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import subprocess
import sys

# the reference example's arguments
ARGS = ["--arch", "smollm-135m", "--steps", "200", "--batch", "4", "--seq", "128",
        "--ckpt-every", "50"]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *ARGS, *argv],
                   check=True)


if __name__ == "__main__":
    main()
