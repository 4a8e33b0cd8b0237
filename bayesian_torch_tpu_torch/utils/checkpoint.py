"""Checkpoints, and weights carried from the JAX package (counterpart of
``bayesian_torch_tpu/utils/checkpoint.py``).

``save_checkpoint`` / ``load_checkpoint`` keep a model's ``state_dict``
(posteriors, BN affine and running statistics; priors are non-persistent
buffers and are rebuilt from the config), as the reference's
``torch.save(state_dict)``. ``save_training_checkpoint`` /
``load_training_checkpoint`` keep the ``--resume`` payload under the JAX
payload's keys: ``model``, ``opt`` (the optimizer's ``state_dict``),
``meta`` (``epoch``, ``best_acc``) and ``rng_count``, and ``sched``, the
learning-rate scheduler's state (the JAX payload's optimizer state holds
its schedule's step count). Where the JAX payload keeps each noise
stream's counter, the port keeps each layer's CPU generator state, so a
resumed run draws the same noise as one that never stopped. Files are written with ``torch.save`` and read back with
``weights_only=True``.

``load_jax_state`` is the reverse of ``import_torch_state_dict``: the port
keeps the reference's parameter names, so a torch ``state_dict`` key
equals the JAX package's ``_torch_key_for`` rendering of an nnx state
path (``layer1.0.downsample.0.mu_kernel``, ``fc.mu_bias``).
``load_jax_quant_state`` does the same for a converted INT8 model, with
its calibration results and frozen draws.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn


def _save(payload, path):
    path = os.path.abspath(os.path.expanduser(str(path)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a run cut mid-write keeps the old checkpoint


def _load(path):
    return torch.load(os.path.expanduser(str(path)), map_location="cpu",
                      weights_only=True)


def _generators(model: nn.Module):
    """{module name: CPU generator} of every layer that draws noise."""
    return {name: mod.generator for name, mod in model.named_modules()
            if isinstance(getattr(mod, "generator", None), torch.Generator)}


def save_checkpoint(model: nn.Module, path) -> None:
    """Save the model's ``state_dict`` to ``path``, overwriting it."""
    _save(model.state_dict(), path)


def load_checkpoint(model: nn.Module, path) -> None:
    """Restore a ``save_checkpoint`` file into ``model`` in place."""
    model.load_state_dict(_load(path))


def save_training_checkpoint(path, model: nn.Module, optimizer=None, *,
                             epoch: int = 0, best_acc: float = 0.0,
                             scheduler=None) -> None:
    """Full training checkpoint: model state, optimizer state, every
    layer's generator state, epoch and best accuracy, and the
    learning-rate scheduler's state (``sched``) when one is given."""
    payload = {
        "model": model.state_dict(),
        "rng_count": {name: gen.get_state()
                      for name, gen in _generators(model).items()},
        "meta": {"epoch": int(epoch), "best_acc": float(best_acc)},
    }
    if optimizer is not None:
        payload["opt"] = optimizer.state_dict()
    if scheduler is not None:
        payload["sched"] = scheduler.state_dict()
    _save(payload, path)


def load_training_checkpoint(path, model: nn.Module, optimizer=None, *,
                             scheduler=None) -> dict:
    """Restore a ``save_training_checkpoint`` payload in place; returns
    ``{"epoch": int, "best_acc": float}`` so a trainer continues from
    the next epoch."""
    payload = _load(path)
    model.load_state_dict(payload["model"])
    gens = _generators(model)
    if set(gens) != set(payload["rng_count"]):
        raise ValueError(
            f"{path}: generator states for {sorted(payload['rng_count'])}, "
            f"model has {sorted(gens)}")
    for name, gen in gens.items():
        gen.set_state(payload["rng_count"][name])
    if optimizer is not None:
        optimizer.load_state_dict(payload["opt"])
    if scheduler is not None:
        scheduler.load_state_dict(payload["sched"])
    return {"epoch": int(payload["meta"]["epoch"]),
            "best_acc": float(payload["meta"]["best_acc"])}


def load_jax_state(model: nn.Module, arrays, *, strict: bool = True):
    """Copy ``{torch-style key: numpy array}`` into ``model`` in place.

    Returns ``(missing_keys, unexpected_keys)``. With ``strict=True``
    raises ``ValueError`` if either is non-empty; a shape mismatch always
    raises. Values are cast to each tensor's dtype (the JAX
    ``num_batches_tracked`` is int32, torch's int64).
    """
    state = model.state_dict()
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    errors = [f"{key}: shape {tuple(np.shape(arrays[key]))} vs model "
              f"{tuple(state[key].shape)}"
              for key in sorted(set(arrays) & set(state))
              if tuple(np.shape(arrays[key])) != tuple(state[key].shape)]
    if errors or (strict and (missing or unexpected)):
        raise ValueError(
            "load_jax_state mismatch:\n"
            + (f"  missing keys: {missing}\n" if missing else "")
            + (f"  unexpected keys: {unexpected}\n" if unexpected else "")
            + (f"  shape errors: {errors}\n" if errors else ""))
    with torch.no_grad():
        for key in sorted(set(arrays) & set(state)):
            dst = state[key]
            dst.copy_(torch.from_numpy(np.asarray(arrays[key])).to(
                dtype=dst.dtype, device=dst.device))
    return missing, unexpected


def load_jax_quant_state(model: nn.Module, arrays, quant_dicts=None, *,
                         strict: bool = True):
    """``load_jax_state`` for a converted (INT8) model.

    ``arrays`` holds the JAX model's state under torch-style keys, its
    ``QuantParam``s included (``conv1.quantized_mu_weight``, ...), and,
    when the JAX model had frozen draws, ``<layer>._frozen_w``,
    ``._frozen_wscale`` and ``._frozen_bias``, which become the layer's
    frozen-draw buffers. ``quant_dicts`` maps a layer's name
    (``layer1.0.conv1``) to its ``quant_dict`` (None: uncalibrated); a
    layer missing from it keeps its own. The scales' host copies are
    rebuilt from the loaded buffers. Returns ``(missing, unexpected)``.
    """
    from bayesian_torch_tpu_torch.layers.quantized_base import (
        FROZEN,
        _QuantizedLayerBase,
    )

    for key in arrays:
        prefix, _, name = key.rpartition(".")
        if name in FROZEN:
            layer = model.get_submodule(prefix)
            if not isinstance(layer, _QuantizedLayerBase):
                raise ValueError(f"{key}: {prefix} is not a quantized layer")
            layer.register_buffer(name, torch.from_numpy(
                np.array(arrays[key])).to(layer.quantized_mu_weight.device))
    result = load_jax_state(model, arrays, strict=strict)
    for name, layer in model.named_modules():
        if isinstance(layer, _QuantizedLayerBase):
            layer._refresh_scales()
            if quant_dicts is not None and name in quant_dicts:
                layer.quant_dict = quant_dicts[name]
    return result
