"""Milliseconds a G step takes in the window: the harness's span around each
``run_epoch(kind="g")`` (which returns a host float, so the span ends with
the epoch's device work), summed and divided by the G steps."""


def read(r):
    if not r.counts.get("g_steps"):
        return None
    return 1e3 * sum(r.spans["g_epoch"]) / r.counts["g_steps"]
