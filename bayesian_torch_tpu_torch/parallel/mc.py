"""Monte-Carlo inference over weight draws (counterpart of
``bayesian_torch_tpu/parallel/mc.py``, eval-only slice).

``mc_forward`` is the Python-loop twin of the JAX scan emission
(``_mc_forward_scan``): every layer's S weight sets are drawn first, by
the batch-sampler kernel in one launch (``_presample_layers``), then a
loop runs the model once per draw with that draw's weights attached.
PyTorch runs eagerly, so the loop is the loop; the JAX ``vmap`` emission,
the structured (channel-tiled) path and meshes come in later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
    sample_scaled_normals_batch,
)
from bayesian_torch_tpu_torch.ops.sampling import draw_seed, sigma_from_rho

_PRESAMPLE = ("auto", "on", "off", "xla", "hash")


def _posterior(layer):
    """(mu, rho) of a conv or linear Bayesian layer's weight, else None."""
    for mu_name, rho_name in (("mu_kernel", "rho_kernel"),
                              ("mu_weight", "rho_weight")):
        mu = getattr(layer, mu_name, None)
        if mu is not None:
            return mu, getattr(layer, rho_name)
    return None


def _presample_layers(model: nn.Module, num_mc: int):
    """Draw every Bayesian layer's ``num_mc`` weight sets in ONE batch
    sampler launch per compute dtype (one launch for a model in one
    dtype). Returns ``[(layer, {attr: (S, ...) tensor})]``.

    All layers' mu and sigma are concatenated into one flat buffer, as the
    JAX function does. Each layer's draws come in its own compute dtype, as
    with presample="off" (the JAX function takes the first layer's for
    all). Draws come back in the logical (O, I, *k) order: the JAX
    (*k, O, I) permutation was a choice of XLA layout. The seed is one
    integer from the group's first layer's CPU generator. Biases are tiny
    and drawn with plain ``torch.randn`` from each layer's generator.
    """
    groups = {}
    for layer in iter_bayesian_layers(model):
        post = _posterior(layer)
        if post is not None:
            dtype = layer.compute_dtype or post[0].dtype
            groups.setdefault(dtype, []).append(layer)
    draws = {}
    for dtype, group in groups.items():
        mus = [_posterior(layer)[0] for layer in group]
        w_all = sample_scaled_normals_batch(
            draw_seed(group[0].generator),
            torch.cat([m.reshape(-1) for m in mus]),
            torch.cat([sigma_from_rho(_posterior(layer)[1]).reshape(-1)
                       for layer in group]), num_mc, dtype)
        off = 0
        for layer, mu in zip(group, mus):
            n = mu.numel()
            draws[layer] = w_all[:, off:off + n].reshape(
                (num_mc,) + tuple(mu.shape))
            off += n

    touched = []
    for layer in iter_bayesian_layers(model):
        if layer not in draws:
            continue
        attrs = {"_presampled_w": draws[layer]}
        if layer.mu_bias is not None:
            eps_b = torch.randn((num_mc,) + tuple(layer.mu_bias.shape),
                                generator=layer.generator)
            attrs["_presampled_b"] = (
                layer.mu_bias + sigma_from_rho(layer.rho_bias)
                * eps_b.to(layer.mu_bias.device))
        touched.append((layer, attrs))
    return touched


def mc_forward(model: nn.Module, x, num_mc: int, *, mesh=None,
               return_kl: bool = True, compute_kl: Optional[bool] = None,
               presample: str = "auto", structured: bool = False,
               emission: str = "auto", reduce: Optional[str] = None):
    """Run ``num_mc`` stochastic forwards of an eval-mode model.

    Returns ``(outputs, kl)``, or ``outputs`` when ``return_kl`` is False.
    Outputs are stacked on a leading MC axis, shape (num_mc, ...), or,
    with ``reduce="mean"``, the predictive mean (batch, ...) in float32,
    accumulated inside the loop. The KL depends on the parameters only,
    so it is the same for every draw and is returned once.
    ``return_kl=False`` also skips evaluating the KL (``compute_kl``
    overrides that link).

    ``presample``: "on" draws every layer's weights with the batch-sampler
    kernel before the loop; "off" samples inside each layer, draw by draw;
    "auto" means "on" here (the JAX default picks an XLA presample that
    steers XLA's fusion, which has no meaning on the card). "xla" and
    "hash" are not ported.

    Eval-only: a module in training mode raises (the MC batch-statistics
    path comes with the training slice). Runs under ``torch.no_grad()``.
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
    if emission == "vmap" or structured or mesh is not None:
        raise NotImplementedError(
            "mc_forward: the vmap emission, structured=True and mesh= are "
            "not ported yet (ROADMAP Queue 1, later slices); the port runs "
            "the draw loop (emission='auto' or 'scan')")
    if presample in ("xla", "hash"):
        raise NotImplementedError(
            f"mc_forward: presample={presample!r} is a TPU code-generation "
            "variant and is not ported (ROADMAP 'Not ported'); use 'on' "
            "or 'off'")
    for mod in model.modules():
        if mod.training and getattr(mod, "track_running_stats", False):
            raise NotImplementedError(
                "mc_forward is eval-only in the port: BN running-stat "
                "updates under MC draws come with the training slice "
                "(ROADMAP Queue 1 #8); call model.eval() first")
    if compute_kl is None:
        compute_kl = return_kl
    kl_off = []
    if not compute_kl:
        for mod in model.modules():
            if getattr(mod, "compute_kl", None) is True:
                mod.compute_kl = False
                kl_off.append(mod)
    presampled = []
    try:
        with torch.no_grad():
            if presample in ("auto", "on") and num_mc > 1:
                presampled = _presample_layers(model, num_mc)
            acc, outs, kl = None, [], 0.0
            for s in range(num_mc):
                for layer, attrs in presampled:
                    for name, stacked in attrs.items():
                        setattr(layer, name, stacked[s])
                out = model(x)
                out, kl = out if isinstance(out, tuple) else (out, 0.0)
                if reduce == "mean":
                    term = out.float() / num_mc
                    acc = term if acc is None else acc + term
                else:
                    outs.append(out)
    finally:
        for layer, attrs in presampled:
            for name in attrs:
                if name in vars(layer):
                    delattr(layer, name)
        for mod in kl_off:
            mod.compute_kl = True
    result = acc if reduce == "mean" else torch.stack(outs)
    if return_kl:
        return result, torch.as_tensor(kl, dtype=torch.float32)
    return result
