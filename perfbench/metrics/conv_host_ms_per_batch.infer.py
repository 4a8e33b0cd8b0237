"""Host ms of a predicted batch inside the Bayesian convs and linears: the
inclusive host ms of its ``layer.bayes`` spans (``perfbench/spans.py``:
the median over the traced units; host time under the profiler, to
compare between commits, not with the window's unit time).
``signs_host_ms_per_batch.infer`` is part of it; the unit's host ms less
it and ``bn_host_ms_per_batch.infer`` is the model's own glue and
``mc_forward``'s bookkeeping."""

from perfbench import spans


def read(ctx):
    return spans.median(ctx, "predict", spans.span_ms("layer.bayes"))
