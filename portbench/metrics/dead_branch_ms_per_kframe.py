"""Host milliseconds of v4_deeper's dead branch per 1,000 frames: the port's
span ``train.dead_branch`` (conv8-10, the text, skip1 and skip2 of each
train-mode forward, whose output the model drops) over its counter
``train.dead_branch_frames`` (the input windows' B x T of each such
forward), both totals of the traced cycle with the tracer on.  None where
the program has no such span."""


def read(r):
    c = r.trace.counts if r.trace is not None else {}
    if not c.get("dead_branch_frames") or "dead_branch_s" not in c:
        return None
    return 1e6 * c["dead_branch_s"] / c["dead_branch_frames"]
