"""Model operations of the whole window (``flops.py``) over its time and
the chips' dense peak in the compute dtype (``roofline.py``), %."""

from perfbench import flops, roofline


def read(ctx):
    w = ctx["window"]
    if ctx["mode"] != "predict" or w["seconds"] <= 0:
        return None
    ops = w["units"] * flops.per_unit(ctx["arch"], ctx["cfg"], ctx["mode"],
                                      ctx["batch"], ctx["num_mc"])
    peak = ctx["chips"] * roofline.PEAK_OPS_PER_S[ctx["cfg"]["compute_dtype"]]
    return 100.0 * ops / (w["seconds"] * peak)
