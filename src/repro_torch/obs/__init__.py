"""Host-side serving metrics (the span tracer comes with the telemetry slice)."""
