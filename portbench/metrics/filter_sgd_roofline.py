"""The lifting filter kernel's share of its roofline in the traced unit: the
least time its work could take, 16 flops per live (unmasked) joint-step per
cycle at the FP32 peak or the live planes' bytes at the HBM peak, whichever
is longer (``counts.filter_bound_s``), over the device time of the kernels
named ``filter_sgd``.  Read only when the trace holds as many launches as
the program counted (``filter_sgd.launches``)."""


def read(r):
    c = r.trace.counts if r.trace is not None else {}
    if "filter_bound_s" not in c:
        return None
    seconds, n = r.trace.seconds_of("filter_sgd")
    if seconds <= 0 or n != c["filter_launches"]:
        return None
    return 100.0 * c["filter_bound_s"] / seconds
