"""Monte-Carlo forwards over weight draws, for inference and training
(counterpart of ``bayesian_torch_tpu/parallel/mc.py``).

``mc_forward`` has two emissions:

- the draw loop (``emission="scan"``, and ``"auto"`` in eval mode), the
  Python-loop twin of the JAX scan emission: S forwards of the model. In
  eval mode every layer's S weight sets are drawn first, by the
  batch-sampler kernel in one launch (``_presample_layers``); in training
  mode the draws are sampled inside the layers;
- the vmap emission (``emission="vmap"``, and ``"auto"`` in training mode,
  JAX ``_mc_forward_inner``): ONE forward in which the draw axis is
  written out in the tensors. The draw
  count is set on every module for the call (``_mc_draws``, as the JAX
  structured path sets ``_mc_structured``); activations are (B, S*C, ...)
  with draw s in channel block s (channels-last: (B, *sp, S*C), where a
  flatten or reshape between the layers that merges that last axis with
  the positions runs draw by draw, as JAX's vmap runs it:
  ``_DrawsLast``), so every Bayesian layer draws its S
  weight sets in one launch, each conv runs all S draws as one grouped
  conv, the fused head runs all S lanes of its sampled GEMM in one launch,
  and BatchNorm normalises each draw's block by that draw's statistics.
  ``torch.func.vmap`` is not used: the layers draw their seeds on the
  host, which would give every lane the same seed.

That layout is the JAX structured path's, so ``structured=True`` is the
vmap emission (less the draw-by-draw merge: JAX's structured mode reads a
channels-last flatten as the draws lie); where a module cannot take the
draw axis it falls back, as JAX's does, with a ``RuntimeWarning`` naming
the module (to the draw loop here, to vmap there). ``mc_vmap`` is JAX's
decorator over independent draws, as S calls of the function.

In training mode the BatchNorm statistics of each draw are recorded and
applied as one EMA update (``_apply_bn_ema``) under either emission;
``remat_policy`` checkpoints each forward the emission makes
(``ops/remat.py``). A converted INT8 model (``quantization.convert``) runs
either emission: with presample "on" its layers build the int8 weights
(Flipout: perturbations) of all S draws in one pass and take their sign
salts before the forwards (``presample``), and the loop takes draw s of
that record where the draw axis takes all of it; frozen draws
(``quantization.serving``) are reused in every draw. Flipout layers run
under both emissions; their presampled draw is the perturbation ``sigma *
eps``.

``mesh=`` (a ``parallel.make_mesh`` mesh over the ranks of a
``torch.distributed`` world) splits the draws over its 'mc' axis and the
batch over its 'data' axis: ``x`` is this rank's block of the batch
(``shard_batch``), and each rank computes its block of draws on it under a
``DrawWindow`` (``ops/sampling.py``), so that every noise tensor it draws
is its block of what one process draws at the same seed: the samplers
take its lanes' counters (K-A with a window, K-C on the same window), the
sign salts its draws' salts, the signs and Dropout masks its rows', and
BatchNorm normalises by the whole batch's statistics. Every rank consumes
the same numbers from every generator as one process does. The blocks are
gathered (``_comm.gather_blocks``: its backward takes this rank's block),
so every rank returns the whole (S, B, ...) outputs, or their mean, and
the KL once: it carries its gradient on the first rank of the (mc, data)
plane alone, so the sum of the ranks' gradients (``reduce_gradients``,
which ``examples/_engine.make_train_step(mesh=)`` calls) is the
single-process gradient. The draw loop cannot skip the draws of other
ranks when they are sampled inside the layers (the generators would part
ways), so there every rank runs every draw and keeps the graph of its own;
with presampled draws (eval, ``presample="on"``) it runs its own alone,
unless a layer draws inside each forward all the same (the LSTM's per-step
weights). The LSTM under the vmap emission draws its block like any layer:
its draws' T lanes of each launch. ``structured=True`` on a channels-last
model runs every draw on every rank, each keeping its own: its reading of
a merge mixes the draws.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import NamedTuple, Optional

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.batchnorm import MCBatchStats
from bayesian_torch_tpu_torch.layers.quantized_base import (
    _QuantizedLayerBase,
)
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops import remat
from bayesian_torch_tpu_torch.ops.conv import channels_last
from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
    sample_scaled_normals_batch,
)
from bayesian_torch_tpu_torch.ops.sampling import (DRAWS_LAST, DrawWindow,
                                                   current_window,
                                                   draw_seed, draw_window,
                                                   module_generators,
                                                   sigma_from_rho,
                                                   sign_salts,
                                                   window_kwargs)
from bayesian_torch_tpu_torch.parallel import _comm, mc_graph
from bayesian_torch_tpu_torch.parallel.mesh import Mesh
from bayesian_torch_tpu_torch.utils import tracing

_PRESAMPLE = ("auto", "on", "off", "xla", "hash")
_BN_STATS = ("ema", "freeze")


def _posterior(layer):
    """(mu, rho) of a conv or linear Bayesian layer's weight, else None."""
    for mu_name, rho_name in (("mu_kernel", "rho_kernel"),
                              ("mu_weight", "rho_weight")):
        mu = getattr(layer, mu_name, None)
        if mu is not None:
            return mu, getattr(layer, rho_name)
    return None


def _is_flipout(layer):
    return getattr(layer, "estimator", None) == "flipout"


@tracing.spanned("presample")
def _presample_layers(model: nn.Module, num_mc: int):
    """Draw every Bayesian layer's ``num_mc`` weight sets in ONE batch
    sampler launch per compute dtype (one launch for a model in one
    dtype). Returns ``[(layer, {attr: a sequence over the S draws})]``:
    (S, ...) tensors, and the INT8 layers' per-draw scales.

    All layers' mu and sigma are concatenated into one flat buffer, as the
    JAX function does. Each layer's draws come in its own compute dtype, as
    with presample="off" (the JAX function takes the first layer's for
    all). Draws come back in the logical (O, I, *k) order: the JAX
    (*k, O, I) permutation was a choice of XLA layout. The seed is one
    integer from the group's first layer's CPU generator. Biases are tiny
    and drawn with plain ``torch.randn`` from each layer's generator.

    A Flipout layer's draw is its perturbation ``delta = sigma * eps``
    (the sampler runs on a zero mean for it; the layer's mean path reads
    ``mu``), its bias draw is ``sigma_b * eps_b`` without ``mu_bias``, and
    its sign salts for the S draws come under one seed of its generator
    (``_presampled_signs``, an (S, 2) int64 tensor on the CPU), so the loop
    and the vmap emission flip the same signs in draw s.

    Differentiable when grad is enabled: the sampler's backward is one
    regenerate-eps launch over the whole flat buffer, and the split back
    into layers has a single concatenation as its backward.

    An INT8 layer gives its own record (``presample``): without a frozen
    draw it builds its S int8 weights (Flipout: perturbations) in one
    pass; a Flipout layer adds its S sign salts.

    Under a mesh that splits the draws the sampler draws this rank's lanes
    of the launch (a window of its counters) and the other records are
    sliced to them: every generator gives what it gives one process. A
    column-parallel shard (``parallel/tp.py``) draws its own window of its
    layer's place in the buffer, one launch a layer; a transposed shard is
    presampled whole, its tensors gathered.

    Two halves: ``_presample_numbers`` takes from the generators what the
    draws need, ``_presample_apply`` makes the draws from those numbers on
    the device. A CUDA graph of the batch (``parallel/mc_graph.py``) runs
    the first on the host before each replay and captures the second.
    """
    with contextlib.ExitStack() as stack:
        for layer in iter_bayesian_layers(model):
            tp = getattr(layer, "_tp", None)
            if tp is not None and not tp.column:
                stack.enter_context(tp.whole(layer))
        return _presample_apply(model, num_mc,
                                _presample_numbers(model, num_mc))


def _column_shard(layer):
    """The layer's column-parallel shard (``parallel/tp.py``), or None."""
    tp = getattr(layer, "_tp", None)
    return tp if tp is not None and tp.column else None


class _Numbers(NamedTuple):
    """What a presample takes from the layers' generators, in the order
    the draws take it: ``groups`` (``{dtype: [layers]}``, one sampler
    launch each) and a seed for each (``seeds``); each biased layer's bias
    noise (``eps_b``: ``{layer: (lanes, *bias shape) f32}``) and each
    Flipout layer's sign salts (``salts``: ``{layer: (lanes, 2) int64}``);
    each INT8 layer's record (``records``), which its build makes as it
    draws. On the host, or (``on``) views of a CUDA graph's static buffer,
    the seeds then one-element int64 tensors."""

    groups: dict
    seeds: list
    eps_b: dict
    salts: dict
    records: dict

    def tensors(self):
        """The numbers as CPU tensors, seeds first, in a fixed order."""
        return [torch.tensor(self.seeds, dtype=torch.int64),
                *self.eps_b.values(), *self.salts.values()]

    def on(self, views):
        """These numbers read from ``views``, device tensors laid out as
        ``tensors()``."""
        seeds, rest = views[0], views[1:]
        k = len(self.eps_b)
        return self._replace(
            seeds=[seeds[i:i + 1] for i in range(len(self.seeds))],
            eps_b=dict(zip(self.eps_b, rest[:k])),
            salts=dict(zip(self.salts, rest[k:])))


def _presample_numbers(model, num_mc):
    """The presample's host half: every number it takes from the layers'
    generators, in the order the eager presample always took them (each
    group's seed, then layer by layer an INT8 layer's build, the bias
    noise, the Flipout salts' seed), as a ``_Numbers``."""
    lane0, lanes = _local_lanes(num_mc)
    groups = {}
    for layer in iter_bayesian_layers(model):
        post = _posterior(layer)
        # a layer being calibrated draws its own noise in its observed
        # forward, and a quantized layer builds its int8 weight per draw
        # inside the layer (it has no float posterior)
        if post is not None and not layer.quant_prepare:
            dtype = layer.compute_dtype or post[0].dtype
            groups.setdefault(dtype, []).append(layer)
    seeds = [draw_seed(group[0].generator) for group in groups.values()]
    drawn = {layer for group in groups.values() for layer in group}

    def mine(seq):
        return seq[lane0:lane0 + lanes]

    eps_b, salts, records = {}, {}, {}
    for layer in iter_bayesian_layers(model):
        if isinstance(layer, _QuantizedLayerBase):
            record = layer.presample(num_mc)
            if record:
                records[layer] = {k: mine(v) for k, v in record.items()}
        if layer not in drawn:
            continue
        if layer.mu_bias is not None:
            tp = _column_shard(layer)
            shape = tuple(layer.mu_bias.shape) if tp is None \
                else tp.whole_shape(layer.mu_bias)
            eps = mine(torch.randn((num_mc,) + shape,
                                   generator=layer.generator))
            eps_b[layer] = eps if tp is None else tp.take(eps, 1)
        if _is_flipout(layer):
            seed = draw_seed(layer.generator)
            salts[layer] = mine(torch.tensor(
                [sign_salts(seed, s) for s in range(num_mc)],
                dtype=torch.int64))
    return _Numbers(groups, seeds, eps_b, salts, records)


def _presample_apply(model, num_mc, numbers):
    """The presample's device half: every layer's draws from ``numbers``
    (``_presample_numbers``), as ``[(layer, {attr: a sequence over the
    draws})]``. Salts on the device stay there: the layers hand them to
    K-H as tensors (``_sign_salts``)."""
    lane0, lanes = _local_lanes(num_mc)
    draws = {}
    for (dtype, group), seed in zip(numbers.groups.items(), numbers.seeds):
        mus = [(torch.zeros_like(_posterior(layer)[0]) if _is_flipout(layer)
                else _posterior(layer)[0]) for layer in group]
        sigmas = [sigma_from_rho(_posterior(layer)[1]) for layer in group]
        tps = [_column_shard(layer) for layer in group]
        whole = [m.numel() if tp is None else tp.whole_numel(m)
                 for m, tp in zip(mus, tps)]
        total = sum(whole)
        if all(tp is None for tp in tps):
            w_all = sample_scaled_normals_batch(
                seed, torch.cat([m.reshape(-1) for m in mus]),
                torch.cat([sg.reshape(-1) for sg in sigmas]), lanes, dtype,
                **window_kwargs(lane0, total, 0, total))
            parts = w_all.split([m.numel() for m in mus], dim=1)
        else:
            # a shard's weights are a window of its layer's place
            offsets = [sum(whole[:k]) for k in range(len(group))]
            parts = [
                (sample_scaled_normals_batch(
                    seed, m.reshape(-1), sg.reshape(-1), lanes, dtype,
                    **window_kwargs(lane0, total, off, m.numel()))
                 if tp is None else
                 tp.presample(seed, m, sg, lanes, dtype, lane0, total, off))
                for m, sg, tp, off in zip(mus, sigmas, tps, offsets)]
        for layer, mu, w in zip(group, mus, parts):
            draws[layer] = w.reshape((lanes,) + tuple(mu.shape))

    touched = []
    for layer in iter_bayesian_layers(model):
        record = numbers.records.get(layer)
        if record:
            touched.append((layer, record))
        if layer not in draws:
            continue
        attrs = {"_presampled_w": draws[layer]}
        if layer in numbers.eps_b:
            b = sigma_from_rho(layer.rho_bias) * numbers.eps_b[layer].to(
                layer.mu_bias.device)
            # Flipout: the mean bias rides the mean path
            attrs["_presampled_b"] = b if _is_flipout(layer) \
                else layer.mu_bias + b
        if layer in numbers.salts:
            attrs["_presampled_signs"] = numbers.salts[layer]
        touched.append((layer, attrs))
    return touched


def _local_lanes(num_mc):
    """(first draw, draws) this rank computes of ``num_mc``: its block
    under a ``DrawWindow`` that splits the draws, else all of them."""
    w = current_window()
    if w is not None and w.splits_draws:
        return w.lane0, w.local_lanes
    return 0, num_mc


def _draws_in_forward(model):
    """Whether a layer of the model draws inside each forward whatever the
    presample (``draws_in_forward``: the LSTM, whose per-step weights are
    drawn for the sequence it is given), so that the draw loop under a mesh
    runs every draw on every rank and the generators stay together."""
    return any(getattr(mod, "draws_in_forward", False)
               for mod in model.modules())


@tracing.spanned("bn_ema")
def _apply_bn_ema(mod, mc_group=None):
    """Average the recorded per-draw batch statistics and apply one EMA
    update, with the factor semantics of torch's own update (momentum, or
    a cumulative average when momentum is None). With ``mc_group`` (a mesh
    that splits the draws) the ranks' draws are gathered first, in draw
    order, so every rank averages all of them."""
    stats = mod._mc_stats.stacked()  # (num_mc, 2, C)
    if mc_group is not None:
        stats = torch.cat(_comm.all_gather(stats, mc_group))
    mean, unbiased_var = stats.mean(dim=0)
    mod.num_batches_tracked.add_(1)
    if mod.momentum is None:
        factor = 1.0 / float(mod.num_batches_tracked)
    else:
        factor = mod.momentum
    mod.running_mean.mul_(1 - factor).add_(factor * mean)
    mod.running_var.mul_(1 - factor).add_(factor * unbiased_var)


def _draw_axis_refusal(model: nn.Module):
    """The first module of the model that cannot take the draw axis, as
    ``(name, module)``, or None: a module that mixes channels and has no
    draw-axis forward (parameters or buffers of its own and no
    ``takes_draw_axis``: a plain ``torch.nn.Conv2d``, ``Linear`` or
    ``BatchNorm2d``), or a layer being calibrated. Parameter-free modules
    (ReLU, pools, containers) are channel-agnostic."""
    for name, mod in model.named_modules():
        own = next(mod.parameters(recurse=False), None) is not None \
            or next(mod.buffers(recurse=False), None) is not None
        if getattr(mod, "quant_prepare", False) or (
                own and not getattr(mod, "takes_draw_axis", False)):
            return name, mod
    return None


def _check_draw_axis(model: nn.Module):
    """Raise, naming the module, if a module of the model cannot take the
    draw axis (``_draw_axis_refusal``)."""
    refused = _draw_axis_refusal(model)
    if refused is not None:
        name, mod = refused
        raise NotImplementedError(
            f"mc_forward(emission='vmap'): module {name or '<model>'!r} "
            f"({type(mod).__name__}) cannot take the draw axis (it "
            "mixes channels and has no draw-axis forward); use the draw "
            "loop (emission='scan')")


def _resolve_emission(model: nn.Module, num_mc: int, training: bool):
    """``emission="auto"`` by the JAX rule (``_resolve_emission``) less its
    TPU work threshold: the vmap emission for a model in training mode
    with more than one draw, the draw loop otherwise (inference, where the
    card agrees with the loop), for a model that cannot take the draw axis
    (a plain ``torch.nn`` layer) and for a converted INT8 model, which
    has nothing to train (it takes the draw axis when asked)."""
    if training and num_mc > 1 and _draw_axis_refusal(model) is None \
            and not any(isinstance(mod, _QuantizedLayerBase)
                        for mod in model.modules()):
        return "vmap"
    return "scan"


@contextlib.contextmanager
def _draw_axis(model: nn.Module, num_mc: int):
    """Set the draw count on every module for one forward; always
    remove it."""
    mods = list(model.modules())
    for mod in mods:
        mod._mc_draws = num_mc
    try:
        yield
    finally:
        for mod in mods:
            del mod._mc_draws


@contextlib.contextmanager
def _mc_batch_stats(model: nn.Module, bn_stats: str, mc_group=None):
    """For the draws of a training-mode model: freeze every
    BatchNorm's running-stat writes and, with ``bn_stats="ema"``, record
    each draw's batch statistics; on success apply one EMA update per
    layer. Always unfreezes and drops the records."""
    frozen, collecting = [], []
    for mod in model.modules():
        if not (isinstance(mod, nn.modules.batchnorm._BatchNorm)
                and mod.training and mod.track_running_stats):
            continue
        if getattr(mod, "stats_frozen", None) is not False:
            raise NotImplementedError(
                f"mc_forward: {type(mod).__name__} in training mode would "
                "update its running statistics once per draw; use the "
                "port's MC-aware bayesian_torch_tpu_torch.nn.BatchNorm"
                "{1,2,3}d (or BatchNorm{1,2,3}dLayer), which records each "
                "draw's statistics for one EMA update")
        frozen.append(mod)
        if bn_stats == "ema":
            collecting.append(mod)
    try:
        for mod in frozen:
            mod.stats_frozen = True
        for mod in collecting:
            mod._mc_stats = MCBatchStats()
        yield
        for mod in collecting:
            _apply_bn_ema(mod, mc_group)
    finally:
        for mod in frozen:
            mod.stats_frozen = False
            mod._mc_stats = None


@tracing.spanned("mc_forward")
def mc_forward(model: nn.Module, x, num_mc: int, *, mesh=None,
               return_kl: bool = True, compute_kl: Optional[bool] = None,
               presample: str = "auto", bn_stats: str = "ema",
               structured: bool = False, emission: str = "auto",
               reduce: Optional[str] = None, remat_policy=None):
    """Run ``num_mc`` stochastic forwards of the model.

    Returns ``(outputs, kl)``, or ``outputs`` when ``return_kl`` is False.
    Outputs are stacked on a leading MC axis, shape (num_mc, ...), or,
    with ``reduce="mean"``, the predictive mean (batch, ...) in float32.
    The KL depends on the parameters only, so it is evaluated once and
    returned once (it enters a loss once). ``return_kl=False`` also skips
    evaluating it (``compute_kl`` overrides that link).

    ``emission``: "scan" runs the draw loop, one forward per draw (the
    mean accumulates inside the loop); "vmap" runs all draws in one
    forward with the draw axis written out in the tensors (module
    docstring), and raises ``NotImplementedError`` naming the first module
    that cannot take it. "auto" follows the JAX rule less its TPU work
    threshold (``_resolve_emission``): vmap for a model in training mode
    with ``num_mc > 1`` that can take the draw axis, the loop otherwise.

    ``structured=True`` (JAX ``_mc_forward_structured``) is the vmap
    emission, whatever ``emission`` says; if a module cannot take the draw
    axis it falls back to the draw loop with a ``RuntimeWarning`` naming
    the module, as JAX falls back to its vmap. ``reduce``, ``bn_stats`` and
    ``return_kl`` behave as under ``emission="vmap"``.

    ``mesh`` (``parallel.make_mesh``): ``x`` is this rank's block of the
    batch (``shard_batch``); the draws split over the mesh's 'mc' axis
    (``num_mc`` must divide evenly over it) and the batch over 'data', and
    every rank returns what one process returns for the whole batch
    (module docstring). "auto" means the vmap emission under a mesh, as in
    JAX, for a model that can take the draw axis; the loop otherwise.

    ``remat_policy`` (with gradients only): ``"full"``, ``"conv_out"`` or a
    ``torch.utils.checkpoint`` selective policy puts each forward the
    emission makes (each draw's under the loop, the one forward under
    vmap) behind a checkpoint that replays its draws (``ops/remat.py``).
    None keeps every draw's activations for the backward. The JAX scan
    always rematerialises its body (its ``remat_policy`` picks only what
    it saves); the results are the same either way, only the memory
    schedule differs.

    ``presample``: "on" draws every layer's weights with the batch-sampler
    kernel before the forwards (differentiable: its backward is one
    regenerate-eps launch); "off" samples inside each layer; "auto" means
    "on" in eval mode under the loop and "off" otherwise, as the JAX
    emissions resolve it ("xla" under the scan, "off" under the vmap).
    Under the vmap emission each layer draws its S weight sets in one
    launch either way. "xla" and "hash" draw ahead of the forwards what the
    JAX ``_presample_layers_xla`` draws (the reparameterization weights,
    the Flipout noise, the quantized weight builds), which is what "on"
    draws here: JAX draws them with rbg ("xla") or with the counter hash
    ("hash"), and the port's noise is always the counter hash through K-A.
    "xla" steers XLA's fusion on the TPU; on the card it means the same
    draws as "hash", and both the same as "on". The LSTM draws its per-step
    weights inside its forward under every setting, as in JAX.

    Training mode (any module's ``training`` set) runs with gradients;
    eval runs under ``torch.no_grad()``. ``num_mc == 1`` is the plain
    forward, with torch's own BatchNorm update. For ``num_mc > 1``,
    ``bn_stats`` controls BatchNorm running statistics:

    - ``"ema"`` (default): each draw normalizes by its own batch
      statistics and records them; after the forwards ONE EMA update from
      their average (``num_batches_tracked`` + 1);
    - ``"freeze"``: running statistics are left untouched.
    """
    if emission not in ("auto", "vmap", "scan"):
        raise ValueError(f"mc_forward: unknown emission {emission!r} "
                         "(expected 'auto', 'vmap' or 'scan')")
    if reduce not in (None, "mean"):
        raise ValueError(f"mc_forward: unknown reduce {reduce!r} "
                         "(expected None or 'mean')")
    if presample not in _PRESAMPLE:
        raise ValueError(f"mc_forward: unknown presample {presample!r} "
                         f"(expected one of {_PRESAMPLE})")
    if bn_stats not in _BN_STATS:
        raise ValueError(f"mc_forward: unknown bn_stats {bn_stats!r} "
                         f"(expected one of {_BN_STATS})")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mc_forward: mesh must come from parallel.make_mesh,"
                        f" got {type(mesh).__name__}")
    remat.resolve_policy(remat_policy)
    if presample in ("xla", "hash"):
        presample = "on"  # the same counter-hash draws (docstring)
    training = any(mod.training for mod in model.modules())
    if structured and num_mc > 1:
        emission = "vmap"
        refused = _draw_axis_refusal(model)
        if refused is not None:
            name, mod = refused
            warnings.warn(
                "mc_forward(structured=True) fell back to the draw loop: "
                f"module {name or '<model>'!r} ({type(mod).__name__}) "
                "cannot take the draw axis", RuntimeWarning, stacklevel=2)
            emission = "scan"
    if emission == "auto":
        emission = ("vmap" if mesh is not None and num_mc > 1
                    and _draw_axis_refusal(model) is None
                    else _resolve_emission(model, num_mc, training))
    vmap = emission == "vmap" and num_mc > 1
    if vmap:
        _check_draw_axis(model)
    if presample == "auto":
        presample = "off" if training or vmap else "on"
    if compute_kl is None:
        compute_kl = return_kl
    block = None
    channels_last_model = vmap and _has_channels_last(model)
    if mesh is not None:
        # the loop splits the draws only when they are all drawn
        # beforehand; structured=True keeps every draw on every rank for a
        # channels-last model (JAX's structured reading of a merge of the
        # draws-last axis mixes the draws)
        block = _MeshBlock(mesh, num_mc, x, (
            vmap and not (structured and channels_last_model)) or (
            presample == "on" and num_mc > 1
            and not _draws_in_forward(model)))
    kl_layers = [mod for mod in model.modules()
                 if getattr(mod, "compute_kl", None) is True]
    def batch(x, numbers=None):
        """The batch, its draws made of ``numbers`` where given (a CUDA
        graph's, ``parallel/mc_graph.py``)."""
        presampled = []
        grad = contextlib.nullcontext() if training else torch.no_grad()
        bn = (_mc_batch_stats(model, bn_stats,
                              block.mc_group if block is not None else None)
              if training and num_mc > 1 else contextlib.nullcontext())
        try:
            with grad, draw_window(None if block is None else block.window):
                if numbers is not None:
                    presampled = _presample_apply(model, num_mc, numbers)
                elif presample == "on" and num_mc > 1:
                    presampled = _presample_layers(model, num_mc)
                run = model
                if channels_last_model and not structured:
                    # F12: a merge of the draws-last axis runs draw by
                    # draw; JAX's structured mode reads it as it lies
                    run = functools.partial(_draws_last_call, model)
                if remat_policy is not None and torch.is_grad_enabled():
                    run = functools.partial(remat.checkpoint, model, run,
                                            policy=remat_policy)
                with bn:
                    if block is None:
                        forward = _forward_draws if vmap else _forward_loop
                        result, kl = forward(run, model, x, num_mc,
                                             presampled, kl_layers,
                                             compute_kl, reduce)
                    else:
                        result, kl = block.forward(
                            run, model, x, presampled, kl_layers,
                            compute_kl, vmap)
            if block is not None:
                result, kl = block.gather(result, kl, reduce, vmap,
                                          training)
        finally:
            for layer, attrs in presampled:
                for name in attrs:
                    if name in vars(layer):
                        delattr(layer, name)
            for mod in kl_layers:
                mod.compute_kl = True
        return result, kl

    if mc_graph.engages(model, x.device if torch.is_tensor(x) else None,
                        num_mc, vmap=vmap, presample=presample, mesh=mesh,
                        remat_policy=remat_policy):
        # an eval batch replayed from a CUDA graph (parallel/mc_graph.py)
        result, kl = mc_graph.forward(
            model, x, (num_mc, reduce, compute_kl),
            host=lambda: _presample_numbers(model, num_mc),
            device_fn=batch, eager=lambda: batch(x))
    else:
        if training:
            mc_graph.release(model)
        result, kl = batch(x)
    if return_kl:
        return result, torch.as_tensor(kl, dtype=torch.float32)
    return result


def _split(out):
    return out if isinstance(out, tuple) else (out, 0.0)


def _forward_loop(run, model, x, num_mc, presampled, kl_layers, compute_kl,
                  reduce, own=None):
    """One forward per draw (``run(x)``: the model, or the model behind a
    checkpoint); the KL in the last draw alone. With ``own`` (a range of
    draws) the other draws run without a graph and are dropped, and the KL
    comes with the last draw of ``own``."""
    acc, outs, kl = None, [], 0.0
    last = num_mc - 1 if own is None else own[-1]
    for s in range(num_mc):
        with tracing.span("draw"):
            for mod in kl_layers:
                mod.compute_kl = compute_kl and s == last
            for layer, attrs in presampled:
                for name, draws in attrs.items():
                    setattr(layer, name, draws[s])
            if own is not None and s not in own:
                with torch.no_grad():
                    model(x)
                continue
            out, kl_s = _split(run(x))
            if s == last:
                kl = kl_s
            if reduce == "mean":
                term = out.float() / num_mc
                acc = term if acc is None else acc + term
            else:
                outs.append(out)
    return (acc if reduce == "mean" else torch.stack(outs)), kl


_MERGES = (torch.flatten, torch.Tensor.flatten, torch.reshape,
           torch.Tensor.reshape, torch.Tensor.view, torch.Tensor.view_as,
           torch.Tensor.reshape_as)
_RELAYOUTS = (torch.permute, torch.Tensor.permute, torch.transpose,
              torch.Tensor.transpose, torch.swapaxes, torch.Tensor.swapaxes,
              torch.swapdims, torch.Tensor.swapdims, torch.movedim,
              torch.Tensor.movedim, torch.moveaxis, torch.Tensor.moveaxis,
              torch.t, torch.Tensor.t, torch.Tensor.mT.__get__,
              torch.Tensor.T.__get__)


def _draws_of(t):
    return getattr(t, DRAWS_LAST, None) if torch.is_tensor(t) else None


def _tagged(args):
    """The first draws-last tensor among ``args`` (one level of lists)."""
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if _draws_of(t):
                return t
    return None


def _keeps_draws_last(out, src):
    return torch.is_tensor(out) and out.dim() == src.dim() \
        and out.dim() >= 3 and out.shape[-1] == src.shape[-1]


class _DrawsLast(torch.overrides.TorchFunctionMode):
    """The vmap emission of a model with channels-last modules (F12): the
    draw axis of a channels-last activation is its last, (B, *sp, S*C),
    where a flatten or reshape that merges that axis with the position
    axes would interleave the draws inside each position, while a layer
    after it (a Linear under the draw axis) reads draw s as block s. Such
    tensors are marked (``DRAWS_LAST``: the draw count): the outputs of
    channels-last modules, and what the code between the layers makes of
    them without moving their last axis. A merge of a marked tensor's last
    axis runs as JAX's vmap runs it, draw by draw on (S, B, *sp, C), its
    results set side by side on the last axis. Inside a layer (a module
    with tensors of its own, a draw-axis forward, a ``data_format`` or a
    generator) the mode steps aside: the layer knows its layout."""

    def __init__(self, num_mc):
        super().__init__()
        self.num_mc = num_mc
        self.depth = 0
        self.kinds = {}  # id(module) -> _is_layer(module), this call's
        self.handles = ()

    def __enter__(self):
        # hooks on every module call while the mode is on: two handles a
        # forward, where a pair on each layer would cost more than the
        # layers' own Python
        self.handles = (
            nn.modules.module.register_module_forward_pre_hook(
                self._enter_layer),
            nn.modules.module.register_module_forward_hook(
                self._leave_layer))
        return super().__enter__()

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        if self.depth:  # a layer raised: the mode is off the stack
            self.depth = 0
            super().__enter__()
        return super().__exit__(*exc)

    def _is_layer(self, mod):
        kind = self.kinds.get(id(mod))
        if kind is None:
            kind = self.kinds[id(mod)] = _is_layer(mod)
        return kind

    def _enter_layer(self, mod, args):
        if not self._is_layer(mod):
            return
        if self.depth == 0:
            super().__exit__(None, None, None)
        self.depth += 1

    def _leave_layer(self, mod, args, out):
        if not self._is_layer(mod):
            return
        self.depth -= 1
        if self.depth:
            return
        first = out[0] if isinstance(out, tuple) else out
        src = _tagged(args)
        if torch.is_tensor(first) and first.dim() >= 3 and (
                channels_last(getattr(mod, "data_format", "NCHW"))
                or (src is not None and first.dim() == src.dim())):
            setattr(first, DRAWS_LAST, self.num_mc)
        super().__enter__()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        src = _tagged(args)
        if src is None:
            return out
        if func in _MERGES and src is args[0] and torch.is_tensor(out) \
                and out.shape[-1] != src.shape[-1] \
                and out.shape[-1] % src.shape[-1] == 0:
            return self._per_draw(src, out.shape)
        if func in _RELAYOUTS:
            return out  # the mode does not follow a change of layout
        if _keeps_draws_last(out, src):
            setattr(out, DRAWS_LAST, self.num_mc)
        return out

    def _per_draw(self, x, shape):
        """``x.reshape(shape)`` run draw by draw, as JAX's vmap runs it:
        each draw's (*sp, C) block to ``shape`` with its last axis over S,
        the S results side by side on the last axis."""
        S = self.num_mc
        per = tuple(shape[:-1]) + (shape[-1] // S,)
        y = x.unflatten(-1, (S, -1)).movedim(-2, 0).reshape((S,) + per)
        y = y.movedim(0, -2).flatten(-2)
        if y.dim() >= 3:
            setattr(y, DRAWS_LAST, S)
        return y


def _is_layer(mod):
    """A module whose forward the draws-last mode leaves alone."""
    return any(t is not None for t in mod._parameters.values()) \
        or any(t is not None for t in mod._buffers.values()) \
        or getattr(mod, "takes_draw_axis", False) \
        or hasattr(mod, "data_format") or hasattr(mod, "generator")


def _has_channels_last(model):
    return any(channels_last(getattr(mod, "data_format", "NCHW"))
               for mod in model.modules())


def _draws_last_call(model, x):
    """``model(x)`` under the draw axis with ``_DrawsLast`` on: the model's
    call under the vmap emission when it has channels-last modules, also
    in a checkpoint's recompute (which replays ``_mc_draws``)."""
    with _DrawsLast(model._mc_draws):
        return model(x)


def _forward_draws(run, model, x, num_mc, presampled, kl_layers, compute_kl,
                   reduce):
    """One forward with the draw axis: the presampled (S, ...) stacks are
    attached whole, and the (..., S*N) output becomes (S, ..., N)."""
    for layer, attrs in presampled:
        for name, stacked in attrs.items():
            setattr(layer, name, stacked)
    for mod in kl_layers:
        mod.compute_kl = compute_kl
    with tracing.span("draw"), _draw_axis(model, num_mc):
        out, kl = _split(run(x))
    outs = out.reshape(out.shape[:-1] + (num_mc, -1)).movedim(-2, 0)
    return (outs.float().mean(0) if reduce == "mean" else outs), kl


class _MeshBlock:
    """This rank's block of an MC forward under a mesh: its draws (its
    'mc' coordinate's, when the emission can split them) on its rows (its
    'data' coordinate's), the ``DrawWindow`` the sampling sites read, and
    the gather of the blocks into the whole result."""

    def __init__(self, mesh, num_mc, x, splits_draws):
        self.mc, self.data = mesh.shape["mc"], mesh.shape["data"]
        if num_mc % self.mc:
            raise ValueError(f"mc_forward: {num_mc} draws do not divide "
                             f"over the mesh's 'mc' axis of {self.mc}")
        self.m, self.d = mesh.coord("mc"), mesh.coord("data")
        self.num_mc = num_mc
        per = num_mc // self.mc
        self.own = range(self.m * per, (self.m + 1) * per)
        self.splits = splits_draws and self.mc > 1
        rows = x.shape[0]
        self.group = mesh.group("mc", "data")
        self.mc_group = mesh.group("mc") if self.splits else None
        self.window = DrawWindow(
            self.own[0] if self.splits else 0,
            per if self.splits else num_mc, num_mc, self.d * rows, rows,
            rows * self.data, mesh.group("data"))

    def forward(self, run, model, x, presampled, kl_layers, compute_kl,
                vmap):
        """(this block's (draws, rows, ...) outputs, KL)."""
        lanes = self.window.local_lanes
        if vmap:
            outs, kl = _forward_draws(run, model, x, lanes, presampled,
                                      kl_layers, compute_kl, None)
            # every draw on every rank (structured, channels-last): ours
            return (outs if self.splits or self.mc == 1
                    else outs[self.own[0]:self.own[-1] + 1]), kl
        if not self.splits:
            # the layers draw inside each draw: run every draw, keep ours
            return _forward_loop(run, model, x, self.num_mc, presampled,
                                 kl_layers, compute_kl, None, own=self.own)
        # presampled draws: ours alone, if no layer draws inside a draw
        gens = module_generators(model)
        before = [gen.get_state() for gen in gens]
        result = _forward_loop(run, model, x, lanes, presampled, kl_layers,
                               compute_kl, None)
        if any(not torch.equal(gen.get_state(), state)
               for gen, state in zip(gens, before)):
            raise RuntimeError(
                "mc_forward(mesh=): a module drew from its generator inside "
                "a presampled draw (Dropout in training mode?), so this "
                "rank's draws cannot skip the others'; use presample='off' "
                "or the vmap emission")
        return result

    def gather(self, outs, kl, reduce, vmap, training):
        """The whole (S, B, ...) outputs (or their mean, reduced as the
        emission reduces without a mesh) on every rank; the KL with its
        gradient on the plane's first rank alone."""
        outs = _comm.gather_blocks(outs, self.group, (self.mc, self.data),
                                   (0, 1), (self.m, self.d))
        if reduce == "mean":
            if vmap:
                outs = outs.float().mean(0)
            else:
                acc = outs[0].float() / self.num_mc
                for s in range(1, self.num_mc):
                    acc = acc + outs[s].float() / self.num_mc
                outs = acc
        if training and torch.is_tensor(kl) and \
                _comm.group_rank(self.group) != 0:
            kl = kl.detach()
        return outs, kl


def mc_vmap(num_mc: int):
    """Decorator (JAX ``mc_vmap``): lift ``f(model, *args)`` over a leading
    axis of ``num_mc`` independent weight draws; the parameters and the
    inputs are broadcast.

        @mc_vmap(10)
        def forward(model, x):
            out, kl = model(x)
            return out, kl

        outs, kls = forward(model, x)   # outs: (10, B, ...), kls: (10,)

    JAX splits the model's noise stream ``num_mc`` ways under one vmapped
    call. Here the draws are ``num_mc`` calls of ``f``, each taking fresh
    draws from the layers' generators, stacked on a new leading axis (each
    element of a tuple result stacked on its own). ``torch.func.vmap``
    would give every lane the same host-drawn seed."""

    def decorator(f):
        @functools.wraps(f)
        def wrapper(model, *args):
            results = [f(model, *args) for _ in range(num_mc)]
            if isinstance(results[0], tuple):
                return tuple(_stack(parts) for parts in zip(*results))
            return _stack(results)

        return wrapper

    return decorator


def _stack(parts):
    return torch.stack([torch.as_tensor(p) for p in parts])
