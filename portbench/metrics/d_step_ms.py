"""Milliseconds a D step takes in the window: the span around each
``run_epoch(kind="d")``, summed and divided by the D steps."""


def read(r):
    if not r.counts.get("d_steps"):
        return None
    return 1e3 * sum(r.spans["d_epoch"]) / r.counts["d_steps"]
