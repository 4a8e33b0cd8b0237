"""Convolutions and products, forward and backward, layout transposes
included: device ms of the kernel class ``conv``
(``kernel_classes/conv.json``) a unit of the traced sub-window, averaged
over the ranks."""


def read(ctx):
    s = ctx["summary"]
    if ctx["mode"] != "train" or not s:
        return None
    ms = s["class_ms"].get("conv", 0.0)
    return ms / s["units"] if ms > 0 else None
