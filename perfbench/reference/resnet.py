"""The plain reference: a Bayesian ResNet's MC forward, its ELBO and its
SGD steps in plain PyTorch, float32 (TF32 off), channels-last.

It is given the weights and inputs that the benchmark made, regenerates
every draw from the seeds (``noise.py``), and computes in blocks: one
draw at a time, one residual block at a time under a checkpoint while
training. Nothing of the program is imported or read.

``q``, the precision of the products: ``None`` for float32, or ``fp8``
below, which rounds both operands of every conv and linear to float8
(e4m3, a scale per tensor) before the product, and their gradients on
the way back: the precision under the configuration's bfloat16, the
control of the comparison (``bf16`` does the same in bfloat16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.arch import Arch
from perfbench.reference import noise

BN_EPS = 1e-5


def _round_fp8(t):
    """``t`` through float8 e4m3 with a scale per tensor."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _round_bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


class _Rounded(torch.autograd.Function):
    """An operand of a product in a lower precision: rounded going
    forward, and its gradient rounded coming back, so the backward's
    products take such operands too."""

    @staticmethod
    def forward(ctx, t, rounding):
        ctx.rounding = rounding
        return rounding(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rounding(g), None


def fp8(t):
    return _Rounded.apply(t, _round_fp8)


def bf16(t):
    """The products' operands in bfloat16: not the control, a look at
    what the configuration's own precision does to the numbers."""
    return _Rounded.apply(t, _round_bf16)


def _id(t):
    return t


def strict_float32():
    """No TF32 in any float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- the draws --------------------------------------------------------------


def infer_plan(arch: Arch, gen: torch.Generator, num_mc: int, flipout: bool):
    """What one MC forward in eval mode takes from the layers' generator:
    one seed for every layer's draws (a launch over all the weights, the
    layers one after another), then, layer by layer, the bias noise (S,
    O) and, for Flipout, the seed of the sign salts."""
    plan = {"seed": noise.draw_seed(gen), "eps_b": {}, "signs": {},
            "offset": {}, "total": 0}
    for layer in arch.layers:
        plan["offset"][layer.name] = plan["total"]
        plan["total"] += layer.weight_numel
    for layer in arch.layers:
        if layer.bias:
            plan["eps_b"][layer.name] = torch.randn((num_mc, layer.cout),
                                                    generator=gen)
        if flipout:
            plan["signs"][layer.name] = noise.draw_seed(gen)
    return plan


def train_plan(arch: Arch, gen: torch.Generator):
    """What one training forward takes: a seed a layer, in forward order,
    for all its draws (weight and bias as one buffer)."""
    return {layer.name: noise.draw_seed(gen) for layer in arch.layers}


def _softplus(rho):
    return F.softplus(rho)


def infer_weight(layer, p, plan, s, flipout, device):
    """Draw s of the layer in eval mode: (weight, bias) of the sampled
    weights, or for Flipout (perturbation, perturbation bias)."""
    n = layer.weight_numel
    eps = noise.normals(noise.draw_salt(plan["seed"], s, plan["total"]),
                        plan["offset"][layer.name], n, device)
    w = _softplus(p["rho"]) * eps.view(layer.weight_shape)
    if not flipout:
        w = p["mu"] + w
    b = None
    if layer.bias:
        b = _softplus(p["rho_bias"]) * plan["eps_b"][layer.name][s].to(device)
        if not flipout:
            b = p["mu_bias"] + b
    return w, b


def train_weight(layer, p, seed, s):
    """Draw s of the layer in a training step (differentiable in mu and
    rho): weight and bias from one stream of n_w + n_b counters."""
    n_w = layer.weight_numel
    n = n_w + (layer.cout if layer.bias else 0)
    eps = noise.normals(noise.draw_salt(seed, s, n), 0, n, p["mu"].device)
    w = p["mu"] + _softplus(p["rho"]) * eps[:n_w].view(layer.weight_shape)
    b = None
    if layer.bias:
        b = p["mu_bias"] + _softplus(p["rho_bias"]) * eps[n_w:]
    return w, b


# --- the layers -------------------------------------------------------------


def product(layer, x, w, b, q):
    """conv (channels-last in and out) or linear, f32 or through ``q``."""
    q = q or _id
    if layer.k == 0:
        y = q(x) @ q(w).t()
    else:
        y = F.conv2d(q(x).permute(0, 3, 1, 2), q(w), None, layer.stride,
                     layer.pad).permute(0, 2, 3, 1)
    return y if b is None else y + b


def flipout_product(layer, x, mu, mu_b, delta, pert_b, salts, q):
    """mean(x) + sign_out * pert(x * sign_in), the signs over the
    channels-last tensors' flat order."""
    s_in = noise.signs(salts[0], tuple(x.shape), x.device)
    mean = product(layer, x, mu, mu_b, q)
    pert = product(layer, x * s_in, delta, pert_b, q)
    del s_in
    return mean + pert * noise.signs(salts[1], tuple(mean.shape), x.device)


def bn_eval(x, p):
    return (x - p["running_mean"]) * torch.rsqrt(p["running_var"] + BN_EPS) \
        * p["weight"] + p["bias"]


def bn_train(x, p, record=None):
    """Normalise by the batch's statistics; ``record`` takes (mean,
    unbiased variance)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = ((x - mean) ** 2).mean(dims)
    if record is not None:
        n = x.numel() // x.shape[-1]
        record(mean.detach(), var.detach() * (n / max(n - 1, 1)))
    return (x - mean) * torch.rsqrt(var + BN_EPS) * p["weight"] + p["bias"]


def maxpool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def forward(arch: Arch, x, layer_fn, bn_fn, remat=False):
    """Logits of one draw: ``layer_fn(layer, x)`` runs a Bayesian layer,
    ``bn_fn(name, x)`` a BatchNorm; with ``remat`` each residual block
    runs under a checkpoint."""
    h = maxpool(torch.relu(bn_fn(arch.stem_bn, layer_fn(arch.stem, x))))

    def block_fn(block, h):
        c1, c2, c3 = block.convs
        out = torch.relu(bn_fn(block.bns[0], layer_fn(c1, h)))
        out = torch.relu(bn_fn(block.bns[1], layer_fn(c2, out)))
        out = bn_fn(block.bns[2], layer_fn(c3, out))
        res = h
        if block.downsample is not None:
            ds, ds_bn = block.downsample
            res = bn_fn(ds_bn, layer_fn(ds, h))
        return torch.relu(out + res)

    for block in arch.blocks:
        if remat:
            h = checkpoint(block_fn, block, h, use_reentrant=False)
        else:
            h = block_fn(block, h)
    return layer_fn(arch.head, h.mean(dim=(1, 2)))


def kl(arch: Arch, layers: dict, cfg: dict, q=None):
    """The sum over layers of the mean-reduced Gaussian KL of the weight
    posterior against the prior, plus that of the bias (of mu and rho
    through ``q``, where given)."""
    mu_p, sig_p = cfg["prior_mu"], cfg["prior_sigma"]
    q = q or _id
    total = 0.0
    for layer in arch.layers:
        p = layers[layer.name]
        pairs = [(p["mu"], p["rho"])]
        if layer.bias:
            pairs.append((p["mu_bias"], p["rho_bias"]))
        for mu, rho in pairs:
            mu, rho = q(mu), q(rho)
            sigma = _softplus(rho)
            term = (math.log(sig_p) - torch.log(sigma)
                    + (sigma ** 2 + (mu - mu_p) ** 2) / (2.0 * sig_p ** 2)
                    - 0.5)
            total = total + term.mean()
    return total


# --- inference --------------------------------------------------------------


def infer_mean(arch: Arch, cfg: dict, weights: dict, x, plan, num_mc: int,
               flipout: bool, q=None, draws=None):
    """The predictive mean (B, N) over ``num_mc`` draws of the eval-mode
    model, and the KL, under the draws of ``plan``; ``draws`` (a range)
    averages those draws alone."""
    layers, bns = weights["layers"], weights["bn"]
    draws = range(num_mc) if draws is None else draws
    acc = None
    with torch.no_grad():
        for s in draws:
            def layer_fn(layer, h, s=s):
                p = layers[layer.name]
                w, b = infer_weight(layer, p, plan, s, flipout, h.device)
                if not flipout:
                    return product(layer, h, w, b, q)
                salts = noise.sign_salts(plan["signs"][layer.name], s)
                return flipout_product(layer, h, p["mu"], p.get("mu_bias"),
                                       w, b, salts, q)

            logits = forward(arch, x, layer_fn,
                             lambda name, h: bn_eval(h, bns[name]))
            term = logits / len(draws)
            acc = term if acc is None else acc + term
        return acc, float(kl(arch, layers, cfg, q))


# --- training ---------------------------------------------------------------


def train_steps(arch: Arch, cfg: dict, weights: dict, batches, plans,
                num_mc: int, batch_size: int, lr: float, momentum: float,
                q=None, grad_rows=None):
    """SGD steps of the ELBO (NLL of the draws' mean log-softmax + KL /
    ``batch_size``) from the given weights, one per (x, y) of ``batches``
    under the seeds of ``plans``; BatchNorm by each draw's batch
    statistics, then one EMA update from their average. ``grad_rows``:
    only the NLL of the batch's first rows enters the gradient (still
    divided by the whole batch), as one rank's part of a data-parallel
    step.

    Returns {'loss': [...], 'nll': [...], 'kl': [...], 'grad1': {leaf:
    gradient of step 1}, 'params': {leaf: value after the steps},
    'running': {bn name: (mean, var) after the steps}} (CPU tensors)."""
    params = {}
    for layer in arch.layers:
        for key, t in weights["layers"][layer.name].items():
            params[f"{layer.name}.{key}"] = t.detach().clone().requires_grad_()
    bn_state = {}
    for name in arch.bn_names:
        p = weights["bn"][name]
        for key in ("weight", "bias"):
            params[f"{name}.{key}"] = p[key].detach().clone().requires_grad_()
        bn_state[name] = [p["running_mean"].clone(),
                          p["running_var"].clone()]
    bufs = {}
    out = {"loss": [], "nll": [], "kl": [], "grad1": {}}

    def layer_p(name, keys):
        return {k: params[f"{name}.{k}"] for k in keys}

    for step, ((x, y), plan) in enumerate(zip(batches, plans)):
        for t in params.values():
            t.grad = None
        stats = {}
        nll_total, kl_value = 0.0, None
        for s in range(num_mc):
            def layer_fn(layer, h, s=s):
                keys = ("mu", "rho") + (("mu_bias", "rho_bias")
                                        if layer.bias else ())
                w, b = train_weight(layer, layer_p(layer.name, keys),
                                    plan[layer.name], s)
                return product(layer, h, w, b, q)

            def bn_fn(name, h, s=s):
                def record(mean, var):
                    stats[(name, s)] = (mean, var)
                return bn_train(h, layer_p(name, ("weight", "bias")), record)

            logits = forward(arch, x, layer_fn, bn_fn, remat=True)
            logp = torch.log_softmax(logits, dim=-1)
            picked = logp.gather(1, y.long()[:, None])
            nll = -picked.mean()
            if grad_rows is None:
                loss = nll / num_mc
            else:
                loss = -picked[:grad_rows].sum() / picked.shape[0] / num_mc
            if s == 0:
                kl_value = kl(arch, {layer.name: layer_p(
                    layer.name, ("mu", "rho") + (("mu_bias", "rho_bias")
                                                 if layer.bias else ()))
                    for layer in arch.layers}, cfg, q)
                loss = loss + kl_value / batch_size
            loss.backward()
            nll_total += float(nll.detach()) / num_mc
            del logits, logp, picked, nll, loss
        k = float(kl_value.detach())
        out["nll"].append(nll_total)
        out["kl"].append(k)
        out["loss"].append(nll_total + k / batch_size)
        with torch.no_grad():
            for name, t in params.items():
                g = t.grad
                if step == 0:
                    out["grad1"][name] = g.detach().cpu()
                buf = bufs.get(name)
                buf = g.clone() if buf is None else buf.mul_(momentum).add_(g)
                bufs[name] = buf
                t.sub_(lr * buf)
            for name in arch.bn_names:
                mean = torch.stack([stats[(name, s)][0]
                                    for s in range(num_mc)]).mean(0)
                var = torch.stack([stats[(name, s)][1]
                                   for s in range(num_mc)]).mean(0)
                rm, rv = bn_state[name]
                m = cfg["bn_momentum"]
                rm.mul_(1 - m).add_(m * mean)
                rv.mul_(1 - m).add_(m * var)
    out["params"] = {name: t.detach().cpu() for name, t in params.items()}
    out["running"] = {name: (rm.cpu(), rv.cpu())
                      for name, (rm, rv) in bn_state.items()}
    return out
