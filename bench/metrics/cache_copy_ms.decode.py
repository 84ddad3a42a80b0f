"""Device ms a decode step spends in the copy kernel group (the cache's
casts to fp32 and the products' layout copies), from the traced window's
kernels grouped by name (``bench/devtrace.py``)."""


def read(ctx):
    if ctx["kind"] != "decode" or not ctx["n_steps"]:
        return None
    sec = ctx["trace"]["groups_s"].get("copy")
    return None if sec is None else sec / ctx["n_steps"] * 1e3
