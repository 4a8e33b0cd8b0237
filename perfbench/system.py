"""The system under test: the only module of the benchmark that imports
the program (``bayesian_torch_tpu_torch``).

It builds a configuration's model with the factory its file names, puts
the benchmark's weights into it, and hands back the two calls the
window drives: ``parallel.mc.mc_forward`` for prediction and
``examples._engine.make_train_step`` with ``torch.optim.SGD`` for
training. What a cell sets of the program comes from its
``workloads/<cell>.json`` and passes through unchanged: ``settings``
(module attributes of the program, ``"module:NAME": value``, set before
the model is built), ``build`` (the factory's keyword arguments),
``entry`` (the window call's keyword arguments) and ``mesh``
(``parallel.make_mesh``'s axes). The calls are looked up on their
modules when they run, so a test can break them underneath.
"""

from __future__ import annotations

import importlib

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# the program's parameter names for the reference's
_CONV_KEYS = {"mu": "mu_kernel", "rho": "rho_kernel"}
_LINEAR_KEYS = {"mu": "mu_weight", "rho": "rho_weight",
                "mu_bias": "mu_bias", "rho_bias": "rho_bias"}


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def param_name(layer, key: str) -> str:
    """The program's name of the reference's leaf ``key`` of ``layer``
    (a BatchNorm's 'weight' and 'bias' keep theirs)."""
    keys = _LINEAR_KEYS if layer.k == 0 else _CONV_KEYS
    return f"{layer.name}.{keys[key]}"


def _attr(path: str):
    """(module, attribute name) of ``module:NAME``."""
    module, _, name = path.partition(":")
    return importlib.import_module(module), name


def apply_settings(settings: dict) -> None:
    """Set each ``module:NAME`` of the program to its value."""
    for path, value in settings.items():
        module, name = _attr(path)
        if not hasattr(module, name):
            raise AttributeError(f"the program has no {path}")
        setattr(module, name, value)


def build(cfg: dict, arch, weights: dict, generator: torch.Generator,
          device, build_kw=None) -> torch.nn.Module:
    """The configuration's model on ``device``, in its layout and compute
    dtype, holding ``weights``; ``build_kw``: the factory's further
    keyword arguments."""
    module, name = _attr(cfg["factory"])
    factory = getattr(module, name)
    model = factory(num_classes=cfg["num_classes"], generator=generator,
                    device=device, data_format=cfg["data_format"],
                    **(build_kw or {}))
    compute = dtype(cfg["compute_dtype"])
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = compute
    load(model, arch, weights)
    return model


def load(model, arch, weights: dict) -> None:
    """Copy the benchmark's weights into the model's parameters and
    BatchNorm buffers."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for layer in arch.layers:
            for key, t in weights["layers"][layer.name].items():
                params[param_name(layer, key)].copy_(t)
        for name, p in weights["bn"].items():
            for key in ("weight", "bias"):
                params[f"{name}.{key}"].copy_(p[key])
            for key in ("running_mean", "running_var"):
                buffers[f"{name}.{key}"].copy_(p[key])


def predict_call(model, num_mc: int, entry: dict, mesh=None):
    """The timed prediction, ``mc_forward(model, x, num_mc, mesh=mesh,
    **entry)``: with ``reduce="mean"`` the MC mean (B, N) in f32 and the
    KL."""
    from bayesian_torch_tpu_torch import parallel

    model.eval()

    def call(x):
        return parallel.mc.mc_forward(model, x, num_mc, mesh=mesh, **entry)
    return call


def train_call(model, num_mc: int, batch_size: int, lr: float,
               momentum: float, entry: dict, mesh=None):
    """The timed ELBO step and its optimizer: ``step(x, y)`` returns the
    detached (loss, nll, kl); ``entry``: ``make_train_step``'s further
    keyword arguments."""
    from bayesian_torch_tpu_torch.examples import _engine

    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
    step = _engine.make_train_step(num_mc=num_mc, batch_size=batch_size,
                                   mesh=mesh, **entry)

    def call(x, y):
        return step(model, opt, x, y)
    return call, opt


def mesh_for(axes: dict):
    """Join the ranks' process group (the launcher set its environment)
    and lay the cell's mesh over them (``make_mesh(**axes)``), every rank
    its card."""
    from bayesian_torch_tpu_torch import parallel
    from bayesian_torch_tpu_torch.parallel import distributed

    distributed.initialize()
    return parallel.make_mesh(**axes)

