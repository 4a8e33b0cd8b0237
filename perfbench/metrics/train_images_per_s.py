"""Trained images a second (the global batch of every step): images whose
ELBO step completed in the window, over the window's whole time (host
clock)."""


def read(ctx):
    if ctx["mode"] != "train" or ctx["seconds"] <= 0:
        return None
    return ctx["images"] / ctx["seconds"]
