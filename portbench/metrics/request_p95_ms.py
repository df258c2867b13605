"""The 95th percentile of the window's request latencies, each from its
submission until its enhanced windows are on the host (``generators/enhance``,
on the card's clock): what one signer waits for a video.  The host's speed
moves it from run to run by more than a bound can hold, so it is read here,
beside the card's time a video costs (``enhance_device_ms_per_video``)."""


def read(r):
    return r.counts.get("request_p95_ms")
