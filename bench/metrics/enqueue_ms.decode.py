"""Host ms a decode step spends inside the program's call
(``decode.step``: enqueueing the step's work), from the program's spans
over the traced window.

Reads the profiling session's per-name totals
(``repro_torch.obs.trace.phase_totals``); nothing unless the session
holds exactly the window's steps and each part a time on this clock (a
program without these spans reads nothing)."""

STEP, PARTS, CLOCK = "decode.step", ("decode.step",), "host_s"


def read(ctx):
    try:
        from repro_torch.obs.trace import phase_totals
    except ImportError:
        return None
    totals, n = phase_totals(), ctx["n_steps"]
    if not n or totals.get(STEP, {}).get("count") != n:
        return None
    secs = [totals.get(p, {}).get(CLOCK) for p in PARTS]
    if any(s is None for s in secs):
        return None
    return 1e3 * sum(secs) / n
