"""The estimator (counterpart of ``repro.core``): state, rankAll, the bulk
update, the estimate, the schemes and the sequential oracles."""
