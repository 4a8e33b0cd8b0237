"""Host ms of a predicted batch inside the BatchNorms: the inclusive host
ms of its ``layer.bn`` spans (``perfbench/spans.py``: the median over the
traced units; host time under the profiler, to compare between commits,
not with the window's unit time). The unit's host ms less it and
``conv_host_ms_per_batch.infer`` is the model's own glue and
``mc_forward``'s bookkeeping."""

from perfbench import spans


def read(ctx):
    return spans.median(ctx, "predict", spans.span_ms("layer.bn"))
