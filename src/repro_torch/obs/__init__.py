"""Runtime telemetry, ported from ``repro/obs``: span tracing with explicit
device-sync boundaries (``obs.trace``), device-side round metrics and the
serving histograms (``obs.metrics``), and the run reporter
(``python -m repro_torch.obs.report``).

Off by default and cheap: with no tracer active every hook dispatches to
the null tracer — no timestamps, no device syncs, no metric launches, no
readbacks.
"""
from repro_torch.obs.metrics import (LatencyHistogram, RollingMeter,  # noqa: F401
                                     ServeStats)
from repro_torch.obs.trace import (RunLog, Tracer, activate,  # noqa: F401
                                   chrome_trace, deactivate, get_tracer,
                                   is_active, metric, span, suspended)

__all__ = [
    "Tracer", "RunLog", "chrome_trace", "activate", "deactivate",
    "get_tracer", "is_active", "span", "metric", "suspended",
    "LatencyHistogram", "RollingMeter", "ServeStats",
]
