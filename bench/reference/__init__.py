"""The plain reference the benchmark holds the program to: the estimator's
semantics in whole-tensor PyTorch (``nbsi.py``) and the comparison that
decides a run's ``correct`` (``compare.py``). Nothing here imports the
program."""
