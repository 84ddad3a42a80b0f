"""The split step's model FLOPs (``bench/arith.py``: the trunk's forward,
the adaptive layers' forward and backward, the head's forward, dW and
dX) over every step of the traced window, as a share of the card's bf16
peak over the window's length (%)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["peaks"] or not ctx["n_steps"]:
        return None
    flops = ctx["work"]["flops_per_step"] * ctx["n_steps"]
    return 100.0 * flops / (ctx["peaks"]["bf16_flops"] * ctx["window_s"])
