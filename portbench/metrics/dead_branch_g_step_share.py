"""Share of the G steps' host time spent in v4_deeper's dead branch: the
port's span ``train.dead_branch`` over its span ``train.g_step``, both
totals of the traced cycle with the tracer on.  None where the program has
no such span."""


def read(r):
    c = r.trace.counts if r.trace is not None else {}
    if not c.get("g_step_s") or "dead_branch_s" not in c:
        return None
    return 100.0 * c["dead_branch_s"] / c["g_step_s"]
