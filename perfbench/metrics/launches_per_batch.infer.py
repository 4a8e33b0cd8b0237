"""Kernel launches on the card a predicted batch (the traced units' device
kernel rows, copies and fills left out), averaged over the ranks."""


def read(ctx):
    s = ctx["summary"]
    if ctx["mode"] != "predict" or not s:
        return None
    return s["launches"] / s["units"] if s["launches"] else None
