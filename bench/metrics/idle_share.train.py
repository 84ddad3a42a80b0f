"""The share of the traced window in which no operation ran on the card,
in the train cells (%)."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"])
