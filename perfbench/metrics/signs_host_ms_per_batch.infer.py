"""Host ms of a predicted batch inside the Flipout sign kernels' wrappers:
the inclusive host ms of its ``kernel.sign_flip`` and
``kernel.sign_combine`` spans, K-H1's and K-H2's operand checks,
geometry and launches (``perfbench/spans.py``: the median over the
traced units; host time under the profiler, to compare between commits,
not with the window's unit time). Part of
``conv_host_ms_per_batch.infer``: the spans sit inside the layers'."""

from perfbench import spans


def read(ctx):
    return spans.median(ctx, "predict",
                        spans.span_ms("kernel.sign_flip",
                                      "kernel.sign_combine"))
