"""Profiling helpers (counterpart of
``bayesian_torch_tpu/utils/profiling.py``), on ``torch.profiler``.

``trace`` writes a chrome trace of its block; ``summarize_trace`` sums the
device rows of the traces in a directory by name. The port's spans
(``utils/tracing.py``) are on inside ``trace``.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
from collections import Counter

import torch

# chrome-trace categories of the rows that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str = "bayesian_torch_tpu_torch_trace"):
    """A ``torch.profiler`` session over the block, CPU and (where there
    is one) CUDA activity, written as a chrome trace into ``logdir``;
    summarize it with ``summarize_trace``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


def _events(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def summarize_trace(logdir: str, top: int = 20, device_only: bool = True):
    """Sum the durations of the complete events of every chrome trace
    under ``logdir`` by name; ``[(name, total_ms)]``, largest first.

    With ``device_only`` (default) only the rows that ran on the device
    count: the events whose ``cat`` is in ``DEVICE_CATEGORIES`` (kernels,
    copies, memsets). A trace taken without a card has none, and gives
    ``[]``."""
    totals = Counter()
    paths = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    paths += glob.glob(os.path.join(logdir, "**", "*.json.gz"),
                       recursive=True)
    for path in sorted(paths):
        for ev in _events(path):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            if device_only and ev.get("cat") not in DEVICE_CATEGORIES:
                continue
            totals[ev.get("name", "?")] += float(ev["dur"])
    return [(name, dur / 1000.0) for name, dur in totals.most_common(top)]
