"""Kernel launches on the card a training step (the traced units' device
kernel rows, copies and fills left out), averaged over the ranks."""


def read(ctx):
    s = ctx["summary"]
    if ctx["mode"] != "train" or not s:
        return None
    return s["launches"] / s["units"] if s["launches"] else None
