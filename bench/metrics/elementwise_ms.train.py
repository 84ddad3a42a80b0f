"""Device ms a split step spends in the elementwise kernel group (the
fp32 logits' and cross-entropy's kernels, Adam's), from the traced
window's kernels grouped by name (``bench/devtrace.py``)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["n_steps"]:
        return None
    sec = ctx["trace"]["groups_s"].get("elementwise")
    return None if sec is None else sec / ctx["n_steps"] * 1e3
