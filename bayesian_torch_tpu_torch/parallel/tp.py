"""Tensor-parallel parameter sharding (counterpart of
``bayesian_torch_tpu/parallel/tp.py``).

JAX places each layer parameter whose name starts with ``mu_``, ``rho_``,
``weight`` or ``bias`` with a sharding that splits its out-feature dim
over a mesh axis, and GSPMD turns the layers into column-parallel GEMMs
and convs, inserting the collectives. Here ``shard_params_tp`` keeps on
each rank of the mesh's 'model' axis its slice of those tensors, under the
same names, and wraps each sharded layer's forward so that its output is
the replicated layer's:

- a Linear or Conv (Bayesian, either estimator, or ``torch.nn``), whose
  out dim is dim 0, is column-parallel: its input passes through
  ``copy_to_group`` (the backward sums the shards' input gradients), it
  computes its out-channels, drawing its noise as the shard's window of
  the whole tensor's counters (K-A with an offset; ``ops.sampling.
  tp_shard``) and its output signs as its channels of the whole output's,
  and the outputs are gathered on the channel dim (dim 1 under NCHW, the
  last dim for a Linear and under a channels-last ``data_format``; one
  all-gather a layer; its backward takes the shard's channels). GSPMD
  would keep the activations channel-sharded through BatchNorm and ReLU
  instead.
- a ConvTranspose (out dim 1, which is no window of the flat kernel) and a
  BatchNorm gather their parameter shards at each forward and at
  ``mc_forward``'s presample (``_Shard.whole``) and compute the whole layer
  on every rank: each rank draws the whole kernel.
- the Bayesian LSTM is gathered too: its cell needs all four gates of a
  unit at every step, so a column split of its 4H rows would gather once a
  time step. Its blocks (``tp_blocks``: ih and hh) keep their row shards;
  the LSTM's forward gathers both once, draws the whole weights from the
  whole launch's counters, runs the replicated cell, and the backward
  hands each rank its rows (the gather's backward).

The KL of a column-parallel Bayesian layer, and of an LSTM's block outside
the LSTM's forward, is the mean of its shards' KL terms (equal shards of
every tensor), summed over 'model' with an identity backward; inside the
forward the block's tensors are whole and so is its KL. An indivisible dim stays replicated, as in JAX
(``_dim_spec``); the count returned is JAX's: the tensors sharded.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from bayesian_torch_tpu_torch.ops.conv import channels_last
from bayesian_torch_tpu_torch.ops.sampling import tp_shard
from bayesian_torch_tpu_torch.parallel import _comm

_PREFIXES = ("mu_", "rho_", "weight", "bias")
_COLUMN = (nn.Linear, nn.modules.conv._ConvNd)


def _out_dim(mod, name, tensor):
    """The out-feature dim of a parameter: 1 for a transposed kernel,
    else 0 (JAX reads the owning module's ``transposed`` flag)."""
    transposed = bool(getattr(mod, "transposed", False))
    return 1 if transposed and tensor.dim() >= 2 and "bias" not in name \
        else 0


def _divides(shape, size, dim):
    return len(shape) > dim and shape[dim] % size == 0 \
        and shape[dim] >= size


class _Shard:
    """One sharded layer: its rank and group on the 'model' axis, the
    dims of its sharded tensors, and whether it is column-parallel."""

    def __init__(self, rank, size, group, dims, column, channel_dim):
        self.rank, self.size, self.group = rank, size, group
        self.dims, self.column = dims, column
        self.channel_dim = channel_dim
        self.gathered = False

    # -- the draws of a column-parallel Bayesian layer -------------------

    def whole_numel(self, t):
        return t.numel() * self.size

    def whole_shape(self, t):
        return (t.shape[0] * self.size,) + tuple(t.shape[1:])

    def window(self, t, lane0=0):
        """The counter window (lane0, lane stride, offset) of this dim-0
        shard of a tensor: its rows of each lane of the whole tensor's
        launch (the fused GEMM's and the bias sampler's under the draw
        axis; ``ops/cuda/sampled_matmul.py``)."""
        return lane0, self.whole_numel(t), self.rank * t.numel()

    def take(self, t, dim):
        """This shard's block of ``t`` along ``dim``."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    def presample(self, seed, mu, sigma, lanes, dtype, lane0, total, off):
        """The presample's draws of a column-parallel shard: its window of
        its layer's place ``off`` in a buffer of ``total`` elements a
        lane."""
        from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
            sample_scaled_normals_batch,
        )
        n = mu.numel()
        return sample_scaled_normals_batch(
            seed, mu.reshape(-1), sigma.reshape(-1), lanes, dtype,
            window=(lane0, total, off + self.rank * n))

    def sample_draws(self, layer, seed, mu, rho, lanes, lane0, dtype,
                     zero_mean):
        """``_sample_draws`` of a shard: the weight and the bias each take
        their window of the whole layer's flat [weight | bias] buffer."""
        from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
            sample_gaussian_batch,
        )
        parts = [(mu, rho)]
        if layer.mu_bias is not None:
            parts.append((layer.mu_bias, layer.rho_bias))
        total = sum(self.whole_numel(m) for m, _ in parts)
        out, start = [], 0
        for m, r in parts:
            mean = torch.zeros_like(m) if zero_mean else m
            out.append(sample_gaussian_batch(
                seed, mean.reshape(-1), r.reshape(-1), lanes, dtype,
                window=(lane0, total, start + self.rank * m.numel())))
            start += self.whole_numel(m)
        return torch.cat(out, dim=1)

    # -- the forward -----------------------------------------------------

    def gather_output(self, mod, out):
        """The whole layer's output from this shard's channels."""
        dim = self.channel_dim % out.dim()
        draws = getattr(mod, "_mc_draws", None)
        if draws:
            # draw s holds channel block s: gather within each block
            shape = list(out.shape)
            split = shape[:dim] + [draws, shape[dim] // draws] \
                + shape[dim + 1:]
            whole = _comm.gather_blocks(out.reshape(split), self.group,
                                        (self.size,), (dim + 1,),
                                        (self.rank,))
            shape[dim] *= self.size
            return whole.reshape(shape)
        return _comm.gather_blocks(out, self.group, (self.size,), (dim,),
                                   (self.rank,))

    @contextlib.contextmanager
    def whole(self, mod):
        """The module's sharded tensors whole (gathered from the shards,
        the backward taking this shard's block) under their names inside;
        the shards after."""
        if self.gathered:
            yield
            return
        whole = {name: _comm.gather_blocks(getattr(mod, name), self.group,
                                           (self.size,), (dim,),
                                           (self.rank,))
                 for name, dim in self.dims.items()}
        for name, t in whole.items():
            mod.__dict__[name] = t  # found before the registered shard
        self.gathered = True
        try:
            yield
        finally:
            self.gathered = False
            for name in whole:
                del mod.__dict__[name]


# injected noise and signs a column-parallel layer takes its block of
_EPS_DIM0 = ("eps_w", "eps_k", "eps_b")


def _column_forward(mod, forward, x, *args, **kwargs):
    tp = mod._tp
    x = _comm.copy_to_group(x, tp.group)
    for name in _EPS_DIM0:
        if kwargs.get(name) is not None:
            kwargs[name] = tp.take(kwargs[name], 0)
    if kwargs.get("sign_out") is not None:
        kwargs["sign_out"] = tp.take(kwargs["sign_out"],
                                     tp.channel_dim % kwargs["sign_out"]
                                     .dim())
    with tp_shard(tp.rank, tp.size, tp.channel_dim):
        out = forward(x, *args, **kwargs)
    if isinstance(out, tuple):
        return (tp.gather_output(mod, out[0]),) + tuple(out[1:])
    return tp.gather_output(mod, out)


def _gathered_forward(mod, forward, *args, **kwargs):
    """``forward`` (the module's forward or KL) on its whole tensors,
    gathered from the shards; the shards return to their names after it."""
    with mod._tp.whole(mod):
        return forward(*args, **kwargs)


def _column_kl(mod, kl_loss):
    """The whole layer's KL: the mean of the shards' (each a mean over
    equal shards), summed over 'model' with an identity backward. Inside
    a gather of the whole tensors (an LSTM's forward) the KL of the whole
    tensors, whose backward hands each rank its block."""
    tp = mod._tp
    if tp.gathered:
        return kl_loss()
    return _comm.sum_replicated(kl_loss(), tp.group) / tp.size


def _blocks_forward(blocks, forward, *args, **kwargs):
    """``forward`` (an LSTM's) with its sharded blocks' tensors whole."""
    with contextlib.ExitStack() as stack:
        for block in blocks:
            stack.enter_context(block._tp.whole(block))
        return forward(*args, **kwargs)


def shard_params_tp(model: nn.Module, mesh, axis: str = "model") -> int:
    """Keep on this rank its out-feature shard of every layer tensor whose
    name starts with ``mu_``, ``rho_``, ``weight`` or ``bias`` (over
    ``mesh[axis]``), and make each sharded layer compute the replicated
    layer's output (module docstring). Returns the number of tensors
    sharded; the others stay replicated. Call it after ``replicate``
    (which would overwrite the shards) and before building the optimizer.
    """
    size = mesh.shape[axis]
    rank, group = mesh.coord(axis), mesh.group(axis)
    composites = [mod for mod in model.modules()
                  if getattr(mod, "tp_blocks", None)]
    in_composite = {id(getattr(mod, name)) for mod in composites
                    for name in mod.tp_blocks}
    sharded = 0
    for mod in model.modules():
        own = list(mod.named_parameters(recurse=False)) + \
            list(mod.named_buffers(recurse=False))
        dims = {}
        for name, t in own:
            if t is None or t.dim() == 0 or not name.startswith(_PREFIXES):
                continue
            dim = _out_dim(mod, name, t)
            if _divides(t.shape, size, dim):
                dims[name] = dim
        if not dims:
            continue
        block = id(mod) in in_composite
        column = not block and not getattr(mod, "transposed", False) and (
            isinstance(mod, _COLUMN) or _posterior_names(mod))
        if not column and not block and not _gathered_kind(mod):
            raise NotImplementedError(
                f"shard_params_tp: {type(mod).__name__} has tensors to "
                "shard but no tensor-parallel forward")
        if column and set(dims) != {n for n, t in own if t is not None
                                    and t.dim() > 0
                                    and n.startswith(_PREFIXES)}:
            # a layer must split all of its out dims or none of them
            continue
        sharded += len(dims)
        if size == 1:
            continue
        for name, dim in dims.items():
            t = getattr(mod, name)
            n = t.shape[dim] // size
            part = t.detach().narrow(dim, rank * n, n).clone()
            if isinstance(t, nn.Parameter):
                setattr(mod, name, nn.Parameter(part,
                                                requires_grad=t.requires_grad))
            else:
                mod._buffers[name] = part
        channel_dim = -1 if _is_linear(mod) or channels_last(
            getattr(mod, "data_format", "NCHW")) else 1
        mod._tp = _Shard(rank, size, group, dims, column, channel_dim)
        forward = mod.forward
        wrap = _column_forward if column else _gathered_forward
        mod.forward = functools.partial(wrap, mod, forward)
        if hasattr(mod, "kl_loss"):
            mod.kl_loss = functools.partial(
                _column_kl if column or block else _gathered_forward, mod,
                mod.kl_loss)
    for mod in composites:
        blocks = [getattr(mod, name) for name in mod.tp_blocks
                  if hasattr(getattr(mod, name), "_tp")]
        if blocks:
            mod.forward = functools.partial(_blocks_forward, blocks,
                                            mod.forward)
    return sharded


def _posterior_names(mod):
    return any(hasattr(mod, n) and getattr(mod, n) is not None
               for n in ("mu_kernel", "mu_weight"))


def _is_linear(mod):
    return isinstance(mod, nn.Linear) or getattr(mod, "mu_weight",
                                                 None) is not None


def _gathered_kind(mod):
    return isinstance(mod, nn.modules.batchnorm._BatchNorm) or \
        bool(getattr(mod, "transposed", False))
