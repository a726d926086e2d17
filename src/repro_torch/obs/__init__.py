"""Serving observability: the metrics registry, per-request trace spans
and MX-health sampling (numpy/host, and torch for the pool scan)."""
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry, percentile,
                                     rate)
from repro_torch.obs.mxhealth import (sample_mx_health,  # noqa: F401
                                      scale_stat_names)
from repro_torch.obs.trace import (TRACE_SCHEMA, Tracer,  # noqa: F401
                                   chrome_events, validate_nesting)
