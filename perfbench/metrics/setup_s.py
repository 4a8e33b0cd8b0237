"""Seconds from the process's start (the launcher's, on several chips)
to the window's start: imports, the kernels' library, the weights, the
model, the inputs and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
