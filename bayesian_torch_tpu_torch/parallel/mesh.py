"""Process meshes for (mc, data[, model]) parallelism (counterpart of
``bayesian_torch_tpu/parallel/mesh.py``).

JAX lays a ``jax.sharding.Mesh`` over devices and lets GSPMD place the
collectives. Here the mesh is laid over the ranks of the
``torch.distributed`` world (``parallel.initialize``), one device each:
``make_mesh`` maps ranks to coordinates as
``np.asarray(ranks).reshape(mc, data[, model])`` does, the coordinates
``torch.distributed.device_mesh.init_device_mesh`` gives the same shape
and names, and builds one process group for each line of each axis and
for each (mc, data) plane. The code that uses the mesh calls the
collectives itself (``parallel/_comm.py``): ``mc_forward(mesh=)``,
``shard_params_tp``, the BatchNorm layers and ``reduce_gradients``.

Every rank of the world must call ``make_mesh`` (and ``replicate``,
``reduce_gradients``) in the same order: creating a group and every
collective are collective calls.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bayesian_torch_tpu_torch.parallel import _comm
from bayesian_torch_tpu_torch.parallel.distributed import (DEFAULT_TIMEOUT,
                                                           local_device)


class Mesh:
    """Ranks on a named grid. ``shape`` maps axis names to sizes (JAX's
    ``mesh.shape``), ``devices`` holds the ranks in grid order, ``coords``
    this rank's coordinate on each axis, ``device`` its torch device."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        found = np.argwhere(ranks == self.rank)
        if len(found) != 1:
            raise ValueError(f"rank {self.rank} is not on the mesh "
                             f"{ranks.tolist()}")
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in found[0])))
        self.device = local_device()
        self._groups = {}
        subsets = [(a,) for a in self.axis_names] + [("mc", "data")]
        if len(self.axis_names) == 3:
            subsets.append(self.axis_names)
        for axes in subsets:
            self._groups[axes] = self._new_groups(axes)

    def _new_groups(self, axes):
        """The group of this rank's line (plane) along ``axes``; every rank
        creates every line's group, in one order."""
        if self.devices.size == 1 or all(self.shape[a] == 1 for a in axes):
            return None
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in keep]
        moved = np.transpose(self.devices, rest + keep)
        lines = moved.reshape(-1, int(np.prod([self.devices.shape[i]
                                               for i in keep])))
        mine = None
        for line in lines:
            group = dist.new_group([int(r) for r in line],
                                   timeout=DEFAULT_TIMEOUT)
            if self.rank in line:
                mine = group
        return mine

    def group(self, *axes):
        """This rank's process group over ``axes`` (its line of one axis,
        its (mc, data) plane, or, with every axis, the mesh), or None when
        it holds one rank. With no axes: the whole mesh."""
        wanted = axes or self.axis_names
        return self._groups[tuple(a for a in self.axis_names
                                  if a in wanted)]

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def first_rank(self) -> int:
        """The rank at the mesh's origin: the source of ``replicate`` and
        the rank that writes checkpoints and logs."""
        return int(self.devices.flat[0])

    @property
    def is_first(self) -> bool:
        return self.rank == self.first_rank

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(mc: int = 1, data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a ('mc', 'data'[, 'model']) mesh over the world's ranks.

    ``mc`` slots carry the Monte-Carlo draws, ``model`` slots carry
    tensor-parallel parameter shards (``parallel.tp``), and the rest go to
    the batch (``data`` defaults to n_ranks // (mc * model)). The 'model'
    axis is only included when model > 1. ``devices``: the ranks to lay
    out, in order (default: every rank of the world; one without a
    process group).
    """
    if devices is None:
        n_world = dist.get_world_size() if dist.is_initialized() else 1
        devices = list(range(n_world))
    n = len(devices)
    if data is None:
        if n % (mc * model) != 0:
            raise ValueError(
                f"{n} devices not divisible by mc*model={mc * model}")
        data = n // (mc * model)
    if mc * data * model != n:
        raise ValueError(f"mesh {mc}x{data}x{model} != {n} devices")
    ranks = np.asarray([int(r) for r in devices])
    if model > 1:
        return Mesh(ranks.reshape(mc, data, model), ("mc", "data", "model"))
    return Mesh(ranks.reshape(mc, data), ("mc", "data"))


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """This rank's block of the leading dim of a host batch (numpy or
    torch), on the rank's device; the dim must divide evenly over
    ``mesh.shape[axis]``."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    parts = mesh.shape[axis]
    if x.shape[0] % parts != 0:
        raise ValueError(f"shard_batch: leading dim {x.shape[0]} does not "
                         f"divide over {axis!r}={parts}")
    rows = x.shape[0] // parts
    block = x.narrow(0, mesh.coord(axis) * rows, rows)
    return block.to(mesh.device)


def replicate(tree, mesh: Mesh):
    """Make every rank of the mesh hold the mesh's first rank's values:
    a module's parameters and buffers and the state of each CPU generator
    its layers draw from (the draws of every rank are windows of the same
    seeds, ``parallel/mc.py``), or a tensor, or a list/tuple/dict of
    tensors. Returns ``tree``."""
    from bayesian_torch_tpu_torch.ops.sampling import module_generators

    group, src = mesh.group(), mesh.first_rank
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in itertools.chain(tree.parameters(), tree.buffers()):
                _comm.broadcast_(t.data, src, group)
        for gen in module_generators(tree):
            state = gen.get_state()
            _comm.broadcast_(state, src, group)
            gen.set_state(state)
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    elif torch.is_tensor(tree):
        with torch.no_grad():
            _comm.broadcast_(tree, src, group)
    return tree


def reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's ``.grad`` over the mesh's (mc, data) plane
    (the ranks that share this rank's 'model' coordinate), after
    ``backward()`` of a loss on ``mc_forward(mesh=)``'s replicated outputs:
    each rank's gradient holds its own draws' and rows' part, and the KL's
    part on the plane's first rank alone. A parameter without a gradient
    takes zeros, so every rank calls the same collectives. A
    tensor-parallel shard is summed with the ranks that hold the same
    shard."""
    group = mesh.group("mc", "data")
    if group is None:
        return
    grads = {}
    for p in model.parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.setdefault((p.grad.dtype, p.grad.device), []).append(
                p.grad)
    for same in grads.values():
        # one collective for each dtype and device
        flat = torch.cat([g.reshape(-1) for g in same])
        _comm.all_reduce_(flat, group)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))

