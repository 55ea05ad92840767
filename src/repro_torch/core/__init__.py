"""The estimator (counterpart of ``repro.core``): state, rankAll, the bulk
update, the estimate and the sequential oracles."""
