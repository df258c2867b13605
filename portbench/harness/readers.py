"""Readings that several per-layer metrics share; each metric's own file
(``metrics/<name>.py``) names the one it reads, as ``read``."""

from portbench.harness import counts


def mfu(r):
    """The whole step's share of the card's FP32 peak: the window's counted
    operations (``counts``, from the configuration's layer shapes) over the
    window's time and the peak."""
    if not r.counts.get("flops"):
        return None
    return 100.0 * r.counts["flops"] / r.counts["window_s"] / counts.PEAK_FP32_FLOPS


def idle(r):
    """Share of the traced unit in which no kernel, copy or set ran on the
    card, from ``torch.profiler``'s device records."""
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def device_ms_per(r, key, per=1):
    """Milliseconds the card was busy in the traced unit per ``per`` of the
    unit's ``key`` (a count the traffic's ``traced_unit`` returns): device
    time, which the host's speed moves far less than the end-to-end rate."""
    c = r.trace.counts if r.trace is not None else {}
    if r.trace is None or r.trace.busy_s <= 0 or not c.get(key):
        return None
    return 1e3 * r.trace.busy_s * per / c[key]
