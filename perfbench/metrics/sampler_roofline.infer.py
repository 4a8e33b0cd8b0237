"""The weight sampler (K-A) of a predicted batch: the least time of the
unit's sampler work (``roofline.sampler_ms``: bytes at the HBM rate or
operations at peak) over the device time of the ``sampler`` kernel class
a unit, %."""

from perfbench import roofline


def read(ctx):
    s = ctx["summary"]
    if ctx["mode"] != "predict" or not s:
        return None
    bound = roofline.sampler_ms(ctx["arch"], ctx["cfg"], ctx["mode"],
                                ctx["num_mc"])
    ms = s["class_ms"].get("sampler", 0.0) / s["units"]
    return 100.0 * bound / ms if ms > 0 and bound > 0 else None
