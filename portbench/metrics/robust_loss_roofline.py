"""The robust-loss kernel's share of its roofline in the traced cycle: the
least time its launches could take, bytes read and written once (12 B per
element and 8 per column, at the HBM peak; ``counts.robust_bound_s``), over
their device time under the kernel's name.  Read only when the trace holds
as many of its launches as the program counted (``robust_lossfun.launches``)
and as the cycle's steps make."""


def read(r):
    c = r.trace.counts if r.trace is not None else {}
    if "robust_launches" not in c:
        return None
    seconds, n = r.trace.seconds_of("robust_loss")
    if seconds <= 0 or not n == c["robust_launches"] == c["robust_expected_launches"]:
        return None
    return 100.0 * c["robust_bound_s"] / seconds
