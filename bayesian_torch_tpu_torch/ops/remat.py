"""Activation checkpointing with replayed draws: the port's ``nnx.remat``
for ``LargeResNet(remat_blocks=...)`` and ``mc_forward(remat_policy=...)``.

``torch.utils.checkpoint`` (non-reentrant) keeps a function's inputs and
runs the function again in the backward pass. Three kinds of state would
make that recompute run another network than the forward ran, and
``checkpoint`` replays each:

- the draws: every seed, Flipout salt and Dropout mask comes from a CPU
  ``torch.Generator`` of a layer (``ops.sampling.replay_generators``);
- the call's attributes, which ``mc_forward`` sets on the modules and
  removes when it returns, before the backward: the draw count
  ``_mc_draws``, the presampled draws ``_presampled_*``, ``compute_kl``
  and BatchNorm's ``stats_frozen``; each is put back as the forward saw it;
- BatchNorm's running statistics, which the recompute must not move again
  (``layers.batchnorm.recomputing``).

``policy`` None (or ``"full"``) saves only the inputs. ``"conv_out"``
saves the output of every convolution (``CONV_OUT``) and recomputes what
lies between them: BatchNorm, ReLU, the residual adds and the draws. It is
a ``torch.utils.checkpoint.create_selective_checkpoint_contexts`` policy,
which sees the aten ops the dispatcher runs: a hand-written kernel is a
call into our own library, not an aten op, so it is always recomputed (K-A
draws the weights again; a conv through K-G, ``CONV_1X1_DOT``, is
recomputed too). A callable is taken as such a policy.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from bayesian_torch_tpu_torch.layers.batchnorm import recomputing
from bayesian_torch_tpu_torch.ops.sampling import replay_generators

_aten = torch.ops.aten
CONV_OUT = (_aten.convolution.default, _aten._convolution.default)
_CALL_ATTRS = ("_mc_draws", "compute_kl", "stats_frozen")


def conv_out_policy(ctx, op, *args, **kwargs):
    """Save the convolutions' outputs, recompute everything else."""
    if op in CONV_OUT:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_policy(policy):
    """None for a full checkpoint, else a selective policy function;
    raises on anything else."""
    if policy is None or policy == "full":
        return None
    if policy == "conv_out":
        return conv_out_policy
    if callable(policy):
        return policy
    raise ValueError(f"remat policy {policy!r}: expected None, 'full', "
                     "'conv_out' or a selective checkpoint policy function")


def _is_call_attr(name):
    return name in _CALL_ATTRS or name.startswith("_presampled")


def _call_state(mods):
    return [{k: v for k, v in vars(mod).items() if _is_call_attr(k)}
            for mod in mods]


def _set_call_state(mods, states):
    for mod, state in zip(mods, states):
        for name in [k for k in vars(mod) if _is_call_attr(k)]:
            if name not in state:
                del vars(mod)[name]
        vars(mod).update(state)


def replay_contexts(module):
    """(forward, recompute) contexts of one checkpointed call of
    ``module``: the generators, the call's attributes and BatchNorm's
    recompute state (module docstring)."""
    mods = list(module.modules())
    gen_forward, gen_recompute = replay_generators(module)
    seen = []

    @contextlib.contextmanager
    def forward():
        seen[:] = _call_state(mods)
        with gen_forward:
            yield

    @contextlib.contextmanager
    def recompute():
        found = _call_state(mods)
        _set_call_state(mods, seen)
        try:
            with gen_recompute, recomputing(module):
                yield
        finally:
            _set_call_state(mods, found)

    return forward(), recompute()


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def checkpoint(module, fn, *args, policy=None):
    """``fn(*args)`` behind a non-reentrant checkpoint whose recompute
    replays ``module``'s draws and call state; ``policy`` as in the module
    docstring."""
    policy = resolve_policy(policy)

    def context_fn():
        forward, recompute = replay_contexts(module)
        if policy is None:
            return forward, recompute
        sac_forward, sac_recompute = \
            create_selective_checkpoint_contexts(policy)
        return _both(sac_forward, forward), _both(sac_recompute, recompute)

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=context_fn)
