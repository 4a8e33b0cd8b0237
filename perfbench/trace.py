"""Reading a ``torch.profiler`` session of a traced sub-window: the device
rows, the time the device was busy (the union of the rows' spans), the
time each kernel class took, the launches, and the idle gaps labelled by
what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import math
from collections import Counter

import torch

# an idle stretch of the device shorter than this is not a gap
GAP_US = 20.0


@contextlib.contextmanager
def profiled(host: bool):
    """A profiler session of the card (and with ``host`` of the host's
    operations) over the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or not \
        torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def summarize(prof, classes, units: int, window_s: float) -> dict:
    """The session's numbers: busy and window seconds, device ms by
    class and by kernel, kernel launches, and the longest idle gaps with
    the innermost host operation running at each gap's middle."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        if e.is_user_annotation and e.device_type == DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((start, end, e.name))
        elif end > start:
            host.append((start, end, e.name))
    device.sort()
    busy_us, edge = 0.0, -math.inf
    gaps = []
    by_kernel, by_class = Counter(), Counter()
    launches = 0
    for start, end, name in device:
        if edge > -math.inf and start - edge > GAP_US:
            gaps.append((start - edge, edge, start))
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
        by_kernel[name] += end - start
        by_class[classes(name)] += end - start
        if "memcpy" not in name.lower() and "memset" not in name.lower():
            launches += 1
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]

    def label(a, b):
        mid = (a + b) / 2
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, name = host[i]
            if mid - s > 5e6:  # no host op that long: stop looking
                break
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "host idle"

    idle = Counter()
    for length, a, b in gaps[:200]:
        idle[label(a, b)] += length
    return {
        "units": units,
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "class_ms": {k: v / 1e3 for k, v in by_class.items()},
        "launches": launches,
        "device_ops": [[n, v / 1e6] for n, v in by_kernel.most_common(10)],
        "idle_gaps": [[n, v / 1e6] for n, v in idle.most_common(10)],
        "unclassed": [n for n, _ in by_kernel.most_common()
                      if classes(n) == "other"][:10],
    }


def merge(summaries: list) -> dict:
    """The ranks' summaries: busy, window, class times and launches
    averaged over the ranks; the first rank's breakdown."""
    n = len(summaries)
    out = dict(summaries[0])
    for key in ("busy_s", "window_s", "launches"):
        out[key] = sum(s[key] for s in summaries) / n
    classes = Counter()
    for s in summaries:
        for k, v in s["class_ms"].items():
            classes[k] += v / n
    out["class_ms"] = dict(classes)
    return out
