"""Host ms of an ELBO step: the ``train_step`` unit's own span, from entry
to return, the wait for the backward included (``perfbench/spans.py``:
the median over the traced units; host time under the profiler, to
compare between commits, not with the window's unit time)."""

from perfbench import spans


def read(ctx):
    return spans.median(ctx, "train", lambda u: u["host_ms"])
