"""The streaming engine and its service loop (counterpart of
``repro.engine``)."""
from repro_torch.engine.engine import (
    EngineConfig,
    SnapshotMismatch,
    StagedChunk,
    TriangleCountEngine,
)
from repro_torch.engine.service import StreamReport, run_stream

__all__ = ["EngineConfig", "SnapshotMismatch", "StagedChunk", "StreamReport",
           "TriangleCountEngine", "run_stream"]
