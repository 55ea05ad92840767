"""Model and workload configurations (``repro.configs``): the LM configs,
each with its published ``FULL`` widths and a ``SMOKE`` size for tests,
and the paper's triangle-stream shapes. Random init from a seed; no
weights are read."""
