"""Host ms of a predicted batch: the ``mc_forward`` unit's own span, from
entry to return (``perfbench/spans.py``: the median over the traced
units; host time under the profiler, to compare between commits, not
with the window's unit time). It less ``conv_host_ms_per_batch.infer``
and ``bn_host_ms_per_batch.infer`` is the model's own glue and
``mc_forward``'s bookkeeping."""

from perfbench import spans


def read(ctx):
    return spans.median(ctx, "predict", lambda u: u["host_ms"])
