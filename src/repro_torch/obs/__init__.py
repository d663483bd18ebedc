# Runtime telemetry (DESIGN.md §13; PyTorch port of ``repro.obs``): span
# timelines, labeled metrics, and structured logging for the epoch
# runtime.  The paper's V_inf accounting already lives in
# RunStats/ChunkSummary; this package makes it observable —
# Chrome-trace epoch/chunk timelines (trace.py), a Prometheus-shaped
# metrics registry with per-tenant latency series (metrics.py), JSONL +
# text-exposition export (export.py), and the shared `repro` logger
# hierarchy (log.py).  Everything is opt-in: NULL_TRACER and plain
# collectors keep the disabled path free.
from .log import configure as configure_logging, get_logger, kv
from .metrics import (
    LATENCY_BUCKETS,
    RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsCollector,
    MetricsError,
    MetricsRegistry,
)
from .trace import (
    NULL_TRACER,
    NullTracer,
    SpanTracer,
    iter_spans,
    load_trace,
    validate_chrome_trace,
)
from .export import (
    export_run_stats,
    iter_samples,
    read_jsonl,
    to_prometheus,
    write_jsonl,
    write_prometheus,
)

__all__ = [
    "LATENCY_BUCKETS",
    "RATIO_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsCollector",
    "MetricsError",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "SpanTracer",
    "configure_logging",
    "export_run_stats",
    "get_logger",
    "iter_samples",
    "iter_spans",
    "kv",
    "load_trace",
    "read_jsonl",
    "to_prometheus",
    "validate_chrome_trace",
    "write_jsonl",
    "write_prometheus",
]
