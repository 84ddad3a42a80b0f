"""Decode's model FLOPs (``bench/arith.py``: 2 x the matrix weights x the
rows, and attention's two products over each step's valid positions)
over every step of the traced window, as a share of the card's bf16
peak over the window's length (%)."""


def read(ctx):
    if ctx["kind"] != "decode" or not ctx["peaks"] or not ctx["n_steps"]:
        return None
    flops = sum(ctx["work"]["flops"])
    return 100.0 * flops / (ctx["peaks"]["bf16_flops"] * ctx["window_s"])
