"""Profiling and speed-of-light helpers (counterpart of
``bayesian_torch_tpu/utils/profiling.py``), on ``torch.profiler``.

``trace`` writes a chrome trace of its block; ``summarize_trace`` sums the
device rows of the traces in a directory by name. ``device_peak_tflops``
gives the card's dense bf16 peak, which ``sol_fraction`` divides by.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
from collections import Counter

import torch

# dense bf16 TFLOP/s by card (NVIDIA's data sheets: tensor cores, no
# sparsity), keyed by a part of torch.cuda.get_device_name(), the first
# match winning; the SXM figure is the one the bounds in PERF.md use
PEAK_BF16_TFLOPS = {
    "h100 pcie": 756.0,
    "h100": 989.0,
}

# chrome-trace categories of the rows that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_peak_tflops(default: float = 989.0) -> float:
    """The dense bf16 peak of card 0 in TFLOP/s, or ``default`` for a card
    not in ``PEAK_BF16_TFLOPS`` or without CUDA."""
    if not torch.cuda.is_available():
        return default
    name = torch.cuda.get_device_name(0).lower()
    for part, peak in PEAK_BF16_TFLOPS.items():
        if part in name:
            return peak
    return default


def sol_fraction(flops_per_step: float, step_seconds: float) -> float:
    """Fraction of bf16 speed-of-light achieved by a step."""
    achieved = flops_per_step / step_seconds / 1e12
    return achieved / device_peak_tflops()


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
