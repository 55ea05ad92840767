"""Model and workload configurations (``repro.configs``): the LM, GNN,
equivariant and recsys configs, each with its published ``FULL`` widths
(``full(d_in, n_classes)`` for the GNNs) and a ``SMOKE`` size for tests,
the cell table's shapes, and the paper's triangle-stream shapes. Random
init from a seed; no weights are read."""
