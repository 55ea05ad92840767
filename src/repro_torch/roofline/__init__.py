"""Roofline analysis (``repro.roofline``): analytic FLOP floors per cell
(``flops``), the three-term roofline with the H100's constants
(``report``), the table (``tables``), and a one-card record of a real step
counted op by op (``count``, the counterpart of the dry run's analysis)."""
