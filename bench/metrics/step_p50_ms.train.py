"""The split step's median time: the host's time between successive
loss readbacks over the traced window (ms)."""
import statistics


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps_s"]:
        return None
    return statistics.median(ctx["steps_s"]) * 1e3
