"""Predicted images a second: images whose predictive mean completed in the
window, over the window's whole time (host clock)."""


def read(ctx):
    if ctx["mode"] != "predict" or ctx["seconds"] <= 0:
        return None
    return ctx["images"] / ctx["seconds"]
