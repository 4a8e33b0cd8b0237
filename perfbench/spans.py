"""The port's spans (``bayesian_torch_tpu_torch/utils/tracing.py``) as
the per-layer metrics of source ``program_span`` read them.

A ``torch.profiler`` session turns the port's spans on, so each traced
unit of a run (``--trace 1``: the cell's ``traced`` units with the
card's activity alone, then one with the host's operations) leaves a
record in the port's store: its host ms and the count and inclusive
host ms of each span in it. A reader takes the records of the cell's
call, ``mc_forward`` for prediction and ``train_step`` for training, and
gives the median over them, so the median is a unit traced for the
card's activity alone in every cell.

These are host times under the profiler, whose cost on each launch
slows the host, and the spans' own cost adds to them: compare them
between commits, not with the window's unit time.
"""

from __future__ import annotations

import statistics

CALLS = {"predict": "mc_forward", "train": "train_step"}


def median(ctx, mode: str, value):
    """The median of ``value(record)`` over the traced records of the
    cell's call, or None: in a cell of the other mode, where the program
    has no spans (a port without ``utils/tracing.py``), or where no record
    gives a value."""
    if ctx["mode"] != mode:
        return None
    try:
        from bayesian_torch_tpu_torch.utils import tracing
    except ImportError:
        return None
    values = [value(u) for u in tracing.units() if u["name"] == CALLS[mode]]
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def span_ms(*names):
    """``value`` for ``median``: the inclusive host ms of the spans
    ``names`` in a record, None where it holds none of them."""
    def value(record):
        found = [record["spans"][n]["ms"] for n in names
                 if n in record["spans"]]
        return sum(found) if found else None
    return value
