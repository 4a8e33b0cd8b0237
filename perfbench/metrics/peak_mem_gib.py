"""The largest ``torch.cuda.max_memory_allocated`` of the window over
the ranks, GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
