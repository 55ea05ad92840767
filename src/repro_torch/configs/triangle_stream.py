"""The paper's own workload: streaming triangle counting.

Shapes follow the evaluation section: r in {2M, 20M} estimators and batch
sizes up to 16M edges (Figure 6 peaks at batch 16M; Table 2 uses r=20M on the
billion-edge graphs). Schemes: pjit coordinated_xla / independent, and the
explicit shard_map coordinated path. The key is the W-distribution mode
(``w_mode`` in repro.core.distributed) — the *estimator scheme* of
repro.core.schemes is a different, orthogonal axis."""
SHAPES = {
    "bulk_s1m_r2m": {"w_mode": "coordinated_xla", "s": 1 << 20, "r": 1 << 21},
    "bulk_s16m_r20m": {"w_mode": "coordinated_xla", "s": 1 << 24,
                       "r": 20_971_520},
    "indep_s1m_r2m": {"w_mode": "independent", "s": 1 << 20, "r": 1 << 21},
    "coord_s1m_r2m": {"w_mode": "shardmap", "s": 1 << 20, "r": 1 << 21},
    "coord_s16m_r20m": {"w_mode": "shardmap", "s": 1 << 24, "r": 20_971_520},
}
