"""The bytes decode must move (``bench/arith.py``: the weights once, the
valid cache positions' keys and values once) over every step of the
traced window, as a share of the card's HBM bandwidth over the window's
length (%)."""


def read(ctx):
    if ctx["kind"] != "decode" or not ctx["peaks"] or not ctx["n_steps"]:
        return None
    nbytes = sum(ctx["work"]["bytes"])
    return 100.0 * nbytes / (ctx["peaks"]["hbm_bytes"] * ctx["window_s"])
