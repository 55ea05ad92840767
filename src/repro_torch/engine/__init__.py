"""The streaming engine, its service loop and batch validation
(counterpart of ``repro.engine``)."""
from repro_torch.engine.engine import (
    EngineConfig,
    SnapshotMismatch,
    StagedChunk,
    TriangleCountEngine,
)
from repro_torch.engine.faults import DeadLetterBuffer, ResilienceConfig, validate_batch
from repro_torch.engine.service import StreamReport, run_stream

__all__ = ["DeadLetterBuffer", "EngineConfig", "ResilienceConfig", "SnapshotMismatch",
           "StagedChunk", "StreamReport", "TriangleCountEngine", "run_stream",
           "validate_batch"]
