"""Carry weights from the JAX package into the port (the reverse of
``import_torch_state_dict`` in ``bayesian_torch_tpu/utils/checkpoint.py``).

The port keeps the reference's parameter names, so a torch ``state_dict``
key equals the JAX package's ``_torch_key_for`` rendering of an nnx state
path (``layer1.0.downsample.0.mu_kernel``, ``fc.mu_bias``). Priors are
non-persistent buffers and are not carried.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
