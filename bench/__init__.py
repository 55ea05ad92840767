"""The benchmark of the PyTorch/CUDA port (``repro_torch``): ``run.py`` is
the command, ``harness.py`` one run of one cell; see README.md."""
