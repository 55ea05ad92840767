"""The streaming engine, its service loops, and the resilience layer: batch
validation, fault plans and bounded retries, the execution plans, and the
elastic serving tier (counterpart of ``repro.engine``)."""
from repro_torch.engine.backends import BACKENDS, BackendPlan, config_scheme, select_backend
from repro_torch.engine.elastic import ElasticBankEngine, ElasticDiagnostics
from repro_torch.engine.engine import (
    EngineConfig,
    EngineDiagnostics,
    SnapshotMismatch,
    StagedChunk,
    TriangleCountEngine,
)
from repro_torch.engine.faults import (
    DeadLetterBuffer,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    ResilienceConfig,
    RetryPolicy,
    fault_plan,
    install_fault_plan,
    parse_fault_plan,
    validate_batch,
    validate_signed_item,
    with_retries,
)
from repro_torch.engine.service import (
    ElasticServeLoop,
    ServeStats,
    StreamReport,
    run_signed_stream,
    run_stream,
)

__all__ = ["BACKENDS", "BackendPlan", "DeadLetterBuffer", "ElasticBankEngine",
           "ElasticDiagnostics", "ElasticServeLoop", "EngineConfig", "EngineDiagnostics",
           "FaultInjected", "FaultPlan", "FaultSpec", "ResilienceConfig", "RetryPolicy",
           "ServeStats", "SnapshotMismatch", "StagedChunk", "StreamReport",
           "TriangleCountEngine", "config_scheme", "fault_plan", "install_fault_plan",
           "parse_fault_plan", "run_signed_stream", "run_stream", "select_backend",
           "validate_batch", "validate_signed_item", "with_retries"]
