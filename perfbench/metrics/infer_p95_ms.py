"""The 95th percentile of the window's batch latencies, each from the
batch's issue to its completion on the card (CUDA events)."""

import statistics


def read(ctx):
    lat = ctx["latencies_ms"]
    if ctx["mode"] != "predict" or len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
