"""Eval MC batches of the draw loop replayed from CUDA graphs (no JAX
counterpart: the JAX package's scan is one compiled XLA program, while the
port's eager loop issues each of a batch's launches from Python, about
3,800 in a ResNet-50 MC-10 batch, so the host sets the pace).

``parallel.mc.mc_forward`` hands an eval call on a CUDA device here when
nothing inside its batch needs the host (``engages``): the draw loop with
every draw presampled, more than one draw, no mesh or ``DrawWindow``, no
checkpoint, no INT8 layer, no layer that draws inside its forward (the
LSTM's per-step weights), no layer being calibrated, no tensor-parallel
shard and no forward hook (a hook's Python would run at the capture
alone). Every other call runs the eager path. The call's ``key`` names what
a capture depends on; for each key:

- the first call runs eager, as without a graph, and so does the lazy
  work once: the kernels' build, cuDNN's plans, cuBLAS's handles;
- the second captures the batch on a side stream into a
  ``torch.cuda.CUDAGraph``: the presample's device half, the S forwards,
  the mean and the KL, reading a static input and a static buffer of the
  presample's host numbers;
- that call and every later one draws the host numbers from the layers'
  generators in the order the eager path draws them, stages them through
  one pinned buffer into the static buffer with one copy, copies ``x`` into
  the static input, replays the graph, and returns clones of its outputs,
  which the next replay overwrites.

So a batch's draws are the eager path's, bit for bit: K-A reads its seeds
and K-H its salts from the static buffer when they run
(``ops/cuda/sampled_weights.py``, ``ops/cuda/flipout_signs.py``). A replay
reads the parameters' memory, so an in-place edit of a parameter or a
buffer needs no new capture; a replaced tensor, another dtype or shape,
another plain value of a module (a ``bool``, number, string, dtype or
device, or a tuple of them, such as a BatchNorm's ``eps`` or a layer's
compute dtype and layout), another input shape, or another value of a
setting in ``SETTINGS`` or of torch's switches makes another key. A
module's values of other kinds (lists, dicts, objects) are not read: a
forward that chooses by them runs as the capture saw them.

The graphs of a device share one memory pool. The ``GRAPHS`` most recently
used keys keep their graphs; a model's graphs go when the model is
collected, and when ``mc_forward`` runs it in training (``release``), so
that a model's eval graphs hold no memory while it trains. A capture that
raises sends its key to the eager path for good, with one
``RuntimeWarning`` naming the cause; that call's batch runs eager on the
numbers already drawn.

A capture runs in the span ``mc_graph.capture``, a replay in
``mc_graph.replay``; ``utils.tracing``'s counters ``captures``, ``replays``
and ``fallbacks`` count them. A replay adds to each kernel wrapper's launch
counter what its capture added, since the replay launches those kernels.
"""

from __future__ import annotations

import collections
import warnings
import weakref

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.quantized_base import (
    _QuantizedLayerBase,
)
from bayesian_torch_tpu_torch.ops import conv as _conv
from bayesian_torch_tpu_torch.ops import qtensor as _qtensor
from bayesian_torch_tpu_torch.ops.sampling import current_window
from bayesian_torch_tpu_torch.utils import tracing

GRAPHS = 4  # keys whose graphs are kept, the most recently used
SEEN = 64  # keys remembered after their first, eager call

# the module-level settings that the eval path reads to choose a route
SETTINGS = ((_conv, "CONV_1X1_DOT"), (_conv, "FLIPOUT_CONV_MODE"),
            (_qtensor, "INT8_RESIDUAL_ADD"))
# the types of a module's plain values, which the key holds
_VALUES = frozenset((bool, int, float, str, type(None), torch.dtype,
                     torch.device))
# the types of nn.Module's own tables (parameters, hooks, submodules), which
# the key passes over
_TABLES = frozenset((collections.OrderedDict, dict, set))


def engages(model, device, num_mc, *, vmap, presample, mesh,
            remat_policy):
    """Whether an ``mc_forward`` call goes to ``forward``: its input on a
    CUDA ``device``, every module in eval, the draw loop with presample
    "on" and more than one draw, no mesh, window or checkpoint policy, no
    global forward hook, and no INT8 layer, layer drawing in its forward,
    layer being calibrated, tensor-parallel shard or module with a forward
    hook in ``model``."""
    hooks = nn.modules.module
    if device is None or device.type != "cuda" or vmap \
            or presample != "on" or num_mc <= 1 or mesh is not None \
            or remat_policy is not None or current_window() is not None \
            or hooks._global_forward_hooks \
            or hooks._global_forward_pre_hooks:
        return False
    for mod in model.modules():
        d = mod.__dict__
        if d["training"] or isinstance(mod, _QuantizedLayerBase) \
                or getattr(type(mod), "draws_in_forward", False) \
                or d.get("draws_in_forward") or d.get("quant_prepare") \
                or d.get("_tp") is not None or d["_forward_hooks"] \
                or d["_forward_pre_hooks"]:
            return False
    return True


def key(modules, x, extra) -> tuple:
    """What a capture depends on: ``extra`` (the call's draws, reduction
    and KL switch), ``x``'s shape, strides, dtype and device, the settings,
    and each module's identity, type and plain values (``_VALUES``, and
    tuples of them) by name, and the address, dtype and shape of each of
    its parameters, buffers and other tensors."""
    b = torch.backends
    out = [extra, tuple(x.shape), x.stride(), x.dtype, x.device,
           tuple(getattr(m, name) for m, name in SETTINGS),
           b.cudnn.enabled, b.cudnn.benchmark, b.cudnn.deterministic,
           b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_autocast_enabled()]
    for mod in modules:
        d = mod.__dict__
        out.append((id(mod), type(mod)))
        for name, v in d.items():
            kind = type(v)
            if kind in _TABLES:
                continue
            if kind in _VALUES or kind is tuple and all(
                    type(e) in _VALUES for e in v):
                out.append((name, v))
            elif isinstance(v, torch.Tensor):
                out.append((name, v.data_ptr(), v.dtype, v.shape))
        for table in (d["_parameters"], d["_buffers"]):
            for t in table.values():
                if t is not None:
                    out.append((t.data_ptr(), t.dtype, t.shape))
    return tuple(out)


class _Staging:
    """The batch's host numbers (CPU tensors of int64 and float32) on their
    way to the graph: one pinned buffer, one static device buffer, one
    copy, and the device views the capture reads."""

    def __init__(self, tensors, device):
        spans, offset = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            spans.append((offset, n))
            offset += -(-n // 8) * 8  # each view 8-byte aligned
        self.host = torch.empty(max(offset, 8), dtype=torch.uint8,
                                pin_memory=True)
        self.dev = torch.empty_like(self.host, device=device)

        def views(buf):
            return [buf[o:o + n].view(t.dtype).view(t.shape)
                    for (o, n), t in zip(spans, tensors)]
        self.host_views, self.dev_views = views(self.host), views(self.dev)
        self.copied = torch.cuda.Event()

    def stage(self, tensors):
        """Write ``tensors`` into the pinned buffer (once the last copy out
        of it has run) and copy it to the device buffer on the current
        stream."""
        self.copied.synchronize()
        for view, t in zip(self.host_views, tensors):
            view.copy_(t)
        self.dev.copy_(self.host, non_blocking=True)
        self.copied.record()


class _Graph:
    """One key's capture: its graph, static input, staging, outputs and
    the launches its capture counted. It holds no module: the graph reads
    the parameters' memory."""

    def __init__(self, x, numbers):
        self.x = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                     device=x.device)
        self.staging = _Staging(numbers.tensors(), x.device)
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None
        self.launches = {}

    def load(self, x, numbers):
        self.staging.stage(numbers.tensors())
        self.x.copy_(x)

    def capture(self, device_fn, numbers, pool, stream):
        """Capture ``device_fn`` on the static input and on ``numbers``
        read from the static buffer."""
        numbers = numbers.on(self.staging.dev_views)
        before = tracing.launches()
        try:
            # the caller's stream comes back even where the capture's end
            # raises before the capture restores it
            with torch.cuda.stream(stream), torch.cuda.graph(
                    self.graph, pool=pool, stream=stream):
                self.outputs = device_fn(self.x, numbers)
        finally:
            after = tracing.launches()
            self.launches = {k: n - before[k] for k, n in after.items()
                             if n != before[k]}
            # counted again at each replay, this one's included
            tracing.add_launches({k: -n for k, n in self.launches.items()})

    def replay(self):
        self.graph.replay()
        tracing.add_launches(self.launches)
        result, kl = self.outputs
        return result.clone(), kl.clone() if torch.is_tensor(kl) else kl


class _Device:
    """A device's graphs: their pool and capture stream, the captured keys
    (least recently used first), the keys seen once and those that fell
    back."""

    def __init__(self, device):
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
            # cuBLAS keeps a workspace for each stream; made inside a
            # capture, it would hold a segment of the pool for good
            with torch.cuda.stream(self.stream):
                for dtype in (torch.float32, torch.bfloat16):
                    one = torch.ones(8, 8, dtype=dtype, device=device)
                    one @ one
        self.graphs = collections.OrderedDict()
        self.seen = collections.OrderedDict()
        self.failed = {}

    def forget(self, model_id, *, collected):
        """Drop a model's graphs, and where the model was ``collected``
        its keys too, which another model may come to have."""
        tables = (self.graphs, self.seen, self.failed) if collected \
            else (self.graphs,)
        for table in tables:
            for k in [k for k in table if k[0] == model_id]:
                del table[k]


_DEVICES = {}


def _forget(device, model_id):
    """A collected model's graphs go (those of the device's state then
    current: a finalizer holds no state)."""
    state = _DEVICES.get(device)
    if state is not None:
        state.forget(model_id, collected=True)


def release(model):
    """Drop ``model``'s graphs, which ``mc_forward`` does when it runs
    the model in training; the next eval batch captures anew. Once no
    graph of a device is left, its pool's memory is the caching
    allocator's to free (``torch.cuda.empty_cache``, or an allocation
    that would fail without it)."""
    for state in _DEVICES.values():
        state.forget(id(model), collected=False)


def reset():
    """Forget every graph and key."""
    _DEVICES.clear()


def forward(model, x, extra, *, host, device_fn, eager):
    """(result, kl) of an engaged eval batch (``engages``). ``host()``
    draws the batch's host numbers (``parallel.mc._presample_numbers``),
    ``device_fn(x, numbers)`` runs the batch on them, ``eager()`` runs the
    whole eager path; so does a call inside another capture."""
    if torch.cuda.is_current_stream_capturing():
        return eager()
    modules = list(model.modules())
    k = (id(model),) + key(modules, x, extra)
    state = _DEVICES.get(x.device)
    if state is None:
        state = _DEVICES[x.device] = _Device(x.device)
    entry = state.graphs.get(k)
    if entry is None:
        if k in state.failed:
            return eager()
        if k not in state.seen:
            state.seen[k] = None
            if len(state.seen) > SEEN:
                state.seen.popitem(last=False)
            return eager()
        numbers = host()
        entry = _Graph(x, numbers)
        entry.load(x, numbers)
        try:
            with tracing.span("mc_graph.capture"):
                entry.capture(device_fn, numbers, state.pool, state.stream)
        except RuntimeError as err:
            state.failed[k] = None
            del state.seen[k]
            tracing.fallbacks.launches += 1
            warnings.warn(
                f"mc_forward: capturing the MC batch as a CUDA graph failed "
                f"({err}); this model and input run eager", RuntimeWarning,
                stacklevel=3)
            return device_fn(x, numbers)
        tracing.captures.launches += 1
        del state.seen[k]
        state.graphs[k] = entry
        if len(state.graphs) > GRAPHS:
            state.graphs.popitem(last=False)
        weakref.finalize(model, _forget, x.device, id(model))
    else:
        state.graphs.move_to_end(k)
        entry.load(x, host())
    with tracing.span("mc_graph.replay"):
        out = entry.replay()
    tracing.replays.launches += 1
    return out
