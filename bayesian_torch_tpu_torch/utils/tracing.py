"""Spans and launch counters of the port, on only while a ``torch.profiler``
session runs.

A span marks one of the port's layer boundaries (``mc_forward``, a draw,
a Bayesian layer, a kernel wrapper, ...)::

    with tracing.span("presample"):
        ...

    @tracing.spanned("layer.bayes")
    def forward(self, x): ...

With no profiler running (``torch.autograd.profiler._is_profiler_enabled``
False) ``span`` returns one shared null context and ``spanned`` calls the
function straight through: nothing is timed, recorded or built. A
profiler session (``utils.profiling.trace``, or any ``torch.profiler``
session) turns the spans on; nothing else does. A span then

- opens ``record_function("btt." + name, args=<unit id>)``, so that it
  lands in the profiler's timeline beside the kernels, on their clock,
  inside the span that encloses it on the same thread;
- adds its host time (``time.perf_counter_ns``) to the record of its unit.

The outermost span on a thread opens a *unit* (``mc_forward`` called
directly, ``train_step``), unless a unit is open in the process already:
a span on another thread (autograd's backward thread on a card) counts
to the unit open there. Each unit keeps its name, its host ms, the count
and inclusive host ms of each span name in it (a span inside one of the
same name on its thread adds its count, not its time), and what each
launch counter rose by. ``units()`` gives the last 256 units, oldest
first; ``reset()`` clears them.

Launch counters: each ``ops/cuda`` wrapper that launches a kernel
registers with ``launch_counter``, which sets its ``launches`` attribute
to 0; the wrapper counts a launch by ``wrapper.launches += 1``, and
``launches()`` reads every counter. ``kernel_span(wrapper)`` is the span
``kernel.<wrapper>`` around the wrapper's route to its launch.
``add_launches`` adds counts to the counters: a CUDA graph's replay adds
what its capture counted (``parallel/mc_graph.py``). ``captures``,
``replays`` and ``fallbacks`` count that module's captures, replays and
captures that failed, kept and recorded as the launch counters are.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
import types

from torch.autograd import profiler as _profiler

RING = 256  # units kept

_NULL = contextlib.nullcontext()
_COUNTERS = {}  # wrapper name -> wrapper
_lock = threading.Lock()
_open = []  # the process's open units, the newest last
_units = collections.deque(maxlen=RING)
_ids = itertools.count(1)


def launch_counter(wrapper):
    """Register ``wrapper``'s launch counter (its ``launches`` attribute,
    set to 0) under its name; returns the wrapper, so it decorates."""
    wrapper.launches = 0
    _COUNTERS[wrapper.__name__] = wrapper
    return wrapper


def launches() -> dict:
    """``{wrapper name: launches}`` of every registered counter."""
    return {name: fn.launches for name, fn in _COUNTERS.items()}


def add_launches(counts: dict) -> None:
    """Add ``{wrapper name: launches}`` to the registered counters."""
    for name, n in counts.items():
        _COUNTERS[name].launches += n


def _counter(name):
    """A count that is no wrapper's, registered as ``name``."""
    return launch_counter(types.SimpleNamespace(__name__=name))


captures = _counter("captures")
replays = _counter("replays")
fallbacks = _counter("fallbacks")


class _Unit:
    """The record of one open unit."""

    def __init__(self, name):
        self.id = next(_ids)
        self.tag = str(self.id)
        self.name = name
        self.spans = {}  # span name -> [count, inclusive ns]
        self.launches = launches()

    def add(self, name, ns):
        with _lock:
            entry = self.spans.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += ns

    def close(self, ns):
        now = launches()
        record = {
            "id": self.id, "name": self.name, "host_ms": ns / 1e6,
            "spans": {k: {"count": c, "ms": t / 1e6}
                      for k, (c, t) in self.spans.items()},
            "launches": {k: n - self.launches.get(k, 0)
                         for k, n in now.items()
                         if n != self.launches.get(k, 0)}}
        with _lock:
            _open.remove(self)
            _units.append(record)


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans


_local = _Local()


class _Span:
    """An open span: its unit, its ``record_function`` and its start."""

    __slots__ = ("name", "unit", "opens", "timed", "record", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        self.opens = False
        if stack:
            self.unit = stack[-1].unit
        else:
            with _lock:
                if _open:
                    self.unit = _open[-1]
                else:
                    self.unit = _Unit(self.name)
                    self.opens = True
                    _open.append(self.unit)
        self.timed = all(s.name != self.name for s in stack)
        stack.append(self)
        self.record = _profiler.record_function("btt." + self.name,
                                                self.unit.tag)
        self.record.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.record.__exit__(*exc)
        _local.stack.pop()
        self.unit.add(self.name, ns if self.timed else 0)
        if self.opens:
            self.unit.close(ns)
        return False


def span(name: str):
    """The span ``name`` over a ``with`` block: the shared null context
    unless a profiler session runs."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def kernel_span(wrapper):
    """The span ``kernel.<wrapper's name>``, the name of its counter."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span("kernel." + wrapper.__name__)


def units() -> list:
    """The last ``RING`` closed units, oldest first: each a dict of
    ``id``, ``name``, ``host_ms``, ``spans`` (``{name: {"count", "ms"}}``)
    and ``launches`` (``{wrapper: launches in the unit}``, those that
    rose)."""
    with _lock:
        return list(_units)


def reset() -> None:
    """Forget the closed units."""
    with _lock:
        _units.clear()
