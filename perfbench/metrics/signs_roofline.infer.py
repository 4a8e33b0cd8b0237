"""The Flipout sign products of a predicted batch (K-H1 input flips, K-H2
output combines): the least time of the unit's sign work
(``roofline.signs_ms``: bytes at the HBM rate or operations at peak) over
the device time of the ``signs`` kernel class a unit, %."""

from perfbench import roofline


def read(ctx):
    s = ctx["summary"]
    if ctx["mode"] != "predict" or not s:
        return None
    bound = roofline.signs_ms(ctx["arch"], ctx["cfg"], ctx["mode"],
                              ctx["num_mc"], ctx["batch"])
    ms = s["class_ms"].get("signs", 0.0) / s["units"]
    return 100.0 * bound / ms if ms > 0 and bound > 0 else None
