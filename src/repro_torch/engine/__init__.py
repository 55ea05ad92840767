"""The streaming engine, its service loops and batch validation
(counterpart of ``repro.engine``)."""
from repro_torch.engine.engine import (
    EngineConfig,
    EngineDiagnostics,
    SnapshotMismatch,
    StagedChunk,
    TriangleCountEngine,
)
from repro_torch.engine.faults import (
    DeadLetterBuffer,
    ResilienceConfig,
    validate_batch,
    validate_signed_item,
)
from repro_torch.engine.service import StreamReport, run_signed_stream, run_stream

__all__ = ["DeadLetterBuffer", "EngineConfig", "EngineDiagnostics", "ResilienceConfig",
           "SnapshotMismatch", "StagedChunk", "StreamReport", "TriangleCountEngine",
           "run_signed_stream", "run_stream", "validate_batch", "validate_signed_item"]
