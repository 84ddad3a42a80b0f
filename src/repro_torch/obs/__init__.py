"""Runtime telemetry, ported from ``repro/obs``: span tracing with host and
device time on the profiler's clock (``obs.trace``), device-side round
metrics and the serving histograms (``obs.metrics``), and the run reporter
(``python -m repro_torch.obs.report``).

Off by default and cheap: with no tracer active and no profiler recording
every hook dispatches to the null tracer — no timestamps, no device
events, no device syncs, no metric launches, no readbacks.
"""
from repro_torch.obs.metrics import (LatencyHistogram, RollingMeter,  # noqa: F401
                                     ServeStats)
from repro_torch.obs.trace import (RunLog, Tracer, activate,  # noqa: F401
                                   chrome_trace, deactivate, get_tracer,
                                   is_active, metric, phase_totals,
                                   profiled, recording, span, suspended)

__all__ = [
    "Tracer", "RunLog", "chrome_trace", "activate", "deactivate",
    "get_tracer", "is_active", "span", "metric", "suspended", "recording",
    "profiled", "phase_totals",
    "LatencyHistogram", "RollingMeter", "ServeStats",
]
