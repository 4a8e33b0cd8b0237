"""Entry point of the port: one Bayesian ResNet-50 MC forward (counterpart
of ``entry`` in the JAX repository's ``__graft_entry__.py``).

    fn, args = entry()          # on the card
    mean_logits, kl = fn(*args)

By default a reduced smoke: Bayesian ResNet-50 (reparameterization) at
64x64, batch 2, 2 weight draws, NCHW (2, 3, 64, 64). With
``BTT_ENTRY_FLAGSHIP=1`` the flagship configuration, as the JAX entry
builds it: channels-last (``data_format="NHWC"``, input (128, 224, 224,
3)), batch 128, 224x224, 10 draws, bf16 compute. The model is
in eval mode, so ``mc_forward`` runs the draw loop with every layer's
draws from one batch-sampler launch. Runs on ``cuda`` unless ``device``
names another device (the tests pass ``"cpu"``).

``dryrun_multichip(n)`` (the JAX ``dryrun_multichip``) runs one sharded
training step of the CIFAR ResNet-20 over n ranks on the JAX choice of
(mc, data, model) for n, then the INT8 QBNN, the structured Flipout
forward of the JAX dryrun's channels-last Net and the draw loop under the
same mesh, each held against the same work in one process:

    dryrun_multichip(4, device="cpu")   # 4 gloo ranks on the CPU
    dryrun_multichip(2)                 # one rank a card (NCCL), or two
                                        # ranks sharing one card (gloo)
"""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large import (
    resnet50,
)
from bayesian_torch_tpu_torch.parallel import mc_forward


def entry(device=None):
    """Return ``(fn, args)``: ``fn(*args)`` gives the MC-mean logits
    (batch, 1000) and the KL."""
    device = torch.device(device if device is not None else "cuda")
    flagship = os.environ.get("BTT_ENTRY_FLAGSHIP", "") == "1"
    data_format = "NHWC" if flagship else "NCHW"
    num_mc = 10 if flagship else 2
    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(0),
                     device=device, data_format=data_format)
    model.eval()
    if flagship:
        for mod in model.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.bfloat16

    def forward(model, x):
        outs, kl = mc_forward(model, x, num_mc)
        return outs.float().mean(dim=0), kl

    shape = (128, 224, 224, 3) if flagship else (2, 3, 64, 64)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    return forward, (model, x.to(device))


def _mesh_sizes(n):
    """The JAX dryrun's (mc, model) for n devices; the rest go to data."""
    if n % 8 == 0:
        return 2, 2
    if n % 4 == 0:
        return 2, 1
    return 1, 1


def _inputs(batch, device, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, 3, 8, 8), generator=gen)
    y = torch.randint(0, 10, (batch,), generator=gen)
    return x.to(device), y.to(device)


def _max_diff(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def _train_step(n, mesh, device):
    """One SGD step of resnet20 under the mesh (tensor-parallel over
    'model' when it has one) against the same step in one process:
    (loss, max |parameter difference| after the step, tensors sharded)."""
    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational import (
        resnet20,
    )
    from bayesian_torch_tpu_torch.parallel import (mc_forward,
                                                   reduce_gradients,
                                                   replicate, shard_batch,
                                                   shard_params_tp)

    mc_size = mesh.shape["mc"]
    num_mc = mc_size * 2
    model = resnet20(generator=torch.Generator().manual_seed(0),
                     device=device).train()
    ref = copy.deepcopy(model)
    replicate(model, mesh)
    sharded = 0
    if mesh.shape.get("model", 1) > 1:
        sharded = shard_params_tp(model, mesh, axis="model")
    x, y = _inputs(n // mc_size * 2, device, seed=1)
    losses = []
    for m, xs, kw in ((model, shard_batch(x, mesh), {"mesh": mesh}),
                      (ref, x, {})):
        opt = torch.optim.SGD(m.parameters(), lr=1e-3)
        opt.zero_grad()
        outs, kl = mc_forward(m, xs, num_mc, **kw)
        loss = F.cross_entropy(outs.float().mean(0), y) + kl / x.shape[0]
        loss.backward()
        if kw:
            reduce_gradients(m, mesh)
        opt.step()
        losses.append(float(loss.detach()))
    worst = 0.0
    ref_params = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        want = ref_params[name]
        owner = model.get_submodule(name.rpartition(".")[0])
        tp = getattr(owner, "_tp", None)
        leaf = name.rpartition(".")[2]
        if tp is not None and leaf in tp.dims:
            want = tp.take(want, tp.dims[leaf])
        worst = max(worst, _max_diff(p, want))
    return model, ref, {"loss": losses[0], "loss_one_process": losses[1],
                        "param_diff": worst, "tp_sharded": sharded}


def _int8_qbnn(mesh, device, num_mc):
    """The JAX dryrun's INT8 net (conv + linear, rho -6), calibrated on
    three batches and converted, under mesh= against no mesh."""
    from torch import nn

    from bayesian_torch_tpu_torch.layers import (Conv2dReparameterization,
                                                 LinearReparameterization)
    from bayesian_torch_tpu_torch.parallel import mc_forward, shard_batch
    from bayesian_torch_tpu_torch.quantization import convert, prepare

    gen = torch.Generator().manual_seed(2)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = Conv2dReparameterization(
                3, 8, 3, padding=1, posterior_rho_init=-6.0, generator=gen,
                device=device)
            self.fc = LinearReparameterization(
                8 * 8 * 8, 10, posterior_rho_init=-6.0, generator=gen,
                device=device)

        def forward(self, x):
            h, k1 = self.conv(x)
            o, k2 = self.fc(h.flatten(1))
            return o, k1 + k2

    net = Net().eval()
    prepare(net)
    xcal, _ = _inputs(4, device, seed=3)
    with torch.no_grad():
        for i in range(3):
            net(xcal + 0.1 * i)
    convert(net)
    return _mesh_vs_one(net, mesh, device, num_mc, return_kl=False)


def _mesh_vs_one(model, mesh, device, num_mc, data_format="NCHW", **kw):
    """max |mc_forward(mesh=) - mc_forward| on one batch (in
    ``data_format``), from the same generator states."""
    from bayesian_torch_tpu_torch.ops.sampling import module_generators
    from bayesian_torch_tpu_torch.parallel import mc_forward, shard_batch

    x, _ = _inputs(max(2 * mesh.devices.size, 4), device, seed=4)
    if data_format != "NCHW":
        x = x.permute(0, 2, 3, 1).contiguous()
    gens = module_generators(model)
    states = [g.get_state() for g in gens]
    with torch.no_grad():
        got = mc_forward(model, shard_batch(x, mesh), num_mc, mesh=mesh,
                         **kw)
        for g, st in zip(gens, states):
            g.set_state(st)
        want = mc_forward(model, x, num_mc, **kw)
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)} differ")
    return _max_diff(got, want)


def _structured_flipout(mesh, device):
    from torch import nn

    from bayesian_torch_tpu_torch.layers import (BatchNorm2dLayer,
                                                 Conv2dFlipout, LinearFlipout)

    gen = torch.Generator().manual_seed(5)

    class Net(nn.Module):
        # the JAX dryrun's Net: channels-last, (batch, 8, 8, 3) in
        def __init__(self):
            super().__init__()
            self.conv = Conv2dFlipout(3, 8, 3, padding=1, generator=gen,
                                      device=device, data_format="NHWC")
            self.bn = BatchNorm2dLayer(8, generator=gen, device=device,
                                       data_format="NHWC")
            self.fc = LinearFlipout(8 * 8 * 8, 10, generator=gen,
                                    device=device)

        def forward(self, x):
            h, k1 = self.conv(x)
            h = torch.relu(self.bn(h))
            o, k2 = self.fc(h.flatten(1))
            return o, k1 + k2

    return _mesh_vs_one(Net().eval(), mesh, device, 4, structured=True,
                        return_kl=False, data_format="NHWC")


def _dryrun_body(n, device):
    """One rank's part of ``dryrun_multichip``: every path under the mesh
    against one process, in f32 without TF32 (a card's TF32 convs round by
    the algorithm, which a rank's smaller batch may change); raises when a
    path disagrees."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        return _dryrun_paths(n, device)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def _dryrun_paths(n, device):
    from bayesian_torch_tpu_torch.parallel import make_mesh

    mc_size, model_size = _mesh_sizes(n)
    mesh = make_mesh(mc=mc_size, model=model_size,
                     data=n // (mc_size * model_size))
    model, ref, res = _train_step(n, mesh, device)
    res["mesh"] = dict(mesh.shape)
    res["int8_qbnn"] = _int8_qbnn(mesh, device, mc_size * 2)
    res["structured_flipout"] = _structured_flipout(mesh, device)
    model.eval()
    res["scan_emission"] = _mesh_vs_one(model, mesh, device, 4,
                                        return_kl=False, emission="scan")
    limits = {"param_diff": 1e-5, "int8_qbnn": 1e-5,
              "structured_flipout": 1e-5, "scan_emission": 1e-5}
    bad = {k: res[k] for k, lim in limits.items() if not res[k] <= lim}
    if bad or abs(res["loss"] - res["loss_one_process"]) > 1e-5:
        raise AssertionError(f"dryrun_multichip({n}): the mesh disagrees "
                             f"with one process: {res}")
    return res


def _dryrun_rank(out_dir, port, rank, n, device):
    """A spawned rank of ``dryrun_multichip``: join the world, run the
    body, write the result (or the error) to ``<out_dir>/<rank>.json``."""
    import traceback

    import torch.distributed as dist

    from bayesian_torch_tpu_torch.parallel import initialize

    torch.set_num_threads(1)
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        initialize(f"127.0.0.1:{port}", num_processes=n, process_id=rank,
                   initialization_timeout=120)
        if torch.device(device).type == "cuda":
            from bayesian_torch_tpu_torch.parallel.distributed import (
                local_device,
            )
            device = local_device()
        result = {"ok": _dryrun_body(n, device)}
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(result, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None, timeout=600):
    """One sharded resnet20 training step on an n-rank mesh (8x8 inputs),
    then the INT8 QBNN, the NHWC structured Flipout forward and the loop
    under the mesh, each against one process; returns rank 0's
    measurements and prints them. Spawns the n ranks (killed after
    ``timeout`` seconds) unless this process already is one of an n-rank
    world. ``device``: ``"cpu"`` (gloo), or the cards (default ``cuda``:
    one rank a card under NCCL, or gloo when there are fewer cards than
    ranks)."""
    import torch.distributed as dist

    device = str(device) if device is not None else "cuda"
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return _dryrun_body(n_devices, device)
    if torch.device(device).type == "cuda":
        from bayesian_torch_tpu_torch.ops.cuda import _build
        _build.build()  # once, before the ranks start
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "from bayesian_torch_tpu_torch.graft_entry import "
             f"_dryrun_rank; _dryrun_rank({out!r}, {port}, {r}, "
             f"{n_devices}, {device!r})"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n_devices)]
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks "
                               f"did not finish within {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r in range(n_devices):
            path = os.path.join(out, f"{r}.json")
            if not os.path.exists(path):
                raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} "
                                   f"wrote nothing:\n{logs[r]}")
            with open(path) as f:
                results.append(json.load(f))
    for r, res in enumerate(results):
        if "error" in res:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} "
                               f"failed:\n{res['error']}")
    res = results[0]["ok"]
    print(f"dryrun_multichip({n_devices}): mesh {res['mesh']}, loss "
          f"{res['loss']:.4f} OK; {json.dumps(res)}")
    return res
