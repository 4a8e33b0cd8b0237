"""BatchNorm, ReLU, adds, pools, casts and copies in torch: device ms of
the kernel class ``glue`` (``kernel_classes/glue.json``) a unit of the
traced sub-window, averaged over the ranks."""


def read(ctx):
    s = ctx["summary"]
    if ctx["mode"] != "predict" or not s:
        return None
    ms = s["class_ms"].get("glue", 0.0)
    return ms / s["units"] if ms > 0 else None
