"""The median gap between successive decode steps' tokens reaching the
host over the traced window (ms)."""
import statistics


def read(ctx):
    if ctx["kind"] != "decode" or not ctx["steps_s"]:
        return None
    return statistics.median(ctx["steps_s"]) * 1e3
