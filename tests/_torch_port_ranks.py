"""Multi-rank runs of the torch port's mesh paths, on the CPU (gloo).

``spawn(name, world, *args)`` starts ``world`` Python processes, each
joining one ``torch.distributed`` world through ``parallel.initialize``
(a ``tcp://`` rendezvous on a port the OS chose) and calling the function
``name`` of this module as ``fn(rank, world, *args)``; it returns their
results in rank order, or raises with the failing rank's traceback. Every
spawn has a wall-clock limit and kills its processes when it passes. The
workers import neither JAX nor the JAX package: the tests hold the
results against JAX themselves.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(name, world, *args, timeout=150):
    """``[fn(rank, world, *args) for each rank]`` of the function ``name``
    of this module (or ``"module:function"``), each in its own process of
    one gloo world."""
    for attempt in range(3):
        port = _free_port()
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "args.pkl"), "wb") as f:
                pickle.dump((name, args), f)
            env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            code = ("from tests._torch_port_ranks import _main; "
                    f"_main({tmp!r}, {{rank}}, {world}, {port})")
            procs = [subprocess.Popen(
                [sys.executable, "-c", code.format(rank=r)], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)]
            deadline = time.monotonic() + timeout
            logs = []
            try:
                for p in procs:
                    left = max(deadline - time.monotonic(), 1)
                    logs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name}: {world} ranks did not finish "
                                     f"within {timeout} s")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            results = []
            for r in range(world):
                path = os.path.join(tmp, f"{r}.pkl")
                if not os.path.exists(path):
                    results.append(("err", logs[r] if r < len(logs)
                                    else "no output"))
                    continue
                with open(path, "rb") as f:
                    results.append(pickle.load(f))
        errors = [v for kind, v in results if kind == "err"]
        if errors and attempt < 2 and any(
                "address already in use" in e.lower() for e in errors):
            continue  # the port was taken before the store bound it
        if errors:
            raise AssertionError(f"{name}: a rank failed:\n{errors[0]}")
        return [v for _, v in results]


def _main(tmp, rank, world, port):
    import torch

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        name, args = pickle.load(f)
    try:
        import torch.distributed as dist

        from bayesian_torch_tpu_torch.parallel import initialize

        n = initialize(f"127.0.0.1:{port}", num_processes=world,
                       process_id=rank, initialization_timeout=60)
        assert n == world, n
        if ":" in name:  # "module:function"
            import importlib
            module, attr = name.split(":")
            fn = getattr(importlib.import_module(module), attr)
        else:
            fn = globals()[name]
        result = ("ok", fn(rank, world, *args))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = ("err", traceback.format_exc())
    with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# ---- the workers -----------------------------------------------------------


def psum(rank, world):
    """The world's sum of rank + 1, and the backend."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return float(t), dist.get_backend()


def small_net(estimator="reparameterization", seed=0, dropout=0.0):
    """Conv -> BatchNorm -> ReLU [-> Dropout] -> Linear on (B, 3, 6, 6),
    all layers on one generator seeded ``seed``."""
    import torch
    from torch import nn

    from bayesian_torch_tpu_torch import layers as L

    gen = torch.Generator().manual_seed(seed)
    flip = estimator == "flipout"

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            conv = L.Conv2dFlipout if flip else L.Conv2dReparameterization
            lin = L.LinearFlipout if flip else L.LinearReparameterization
            self.conv = conv(3, 4, 3, padding=1, posterior_rho_init=-2.0,
                             generator=gen)
            self.bn = L.BatchNorm2dLayer(4, generator=gen)
            self.drop = L.Dropout(dropout, generator=gen)
            self.fc = lin(4 * 6 * 6, 5, posterior_rho_init=-2.0,
                          generator=gen)

        def forward(self, x):
            h, k1 = self.conv(x)
            h = self.drop(torch.relu(self.bn(h)))
            o, k2 = self.fc(h.flatten(1))
            return o, k1 + k2

    return Net()


def _batch(rows=8, seed=3):
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(rows, 3, 6, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 5, rows).astype(np.int64))
    return x, y


def _loss(outs, kl, y):
    import torch

    log_probs = torch.log_softmax(outs.float(), dim=-1).mean(0)
    return -log_probs.gather(1, y[:, None]).mean() + kl / y.shape[0]


def mc_parity(rank, world, mc, data, num_mc, kw, training, estimator,
              dropout=0.0, steps=1):
    """``mc_forward(mesh=make_mesh(mc, data))`` on this rank's rows
    against ``mc_forward`` of the whole batch in this process, ``steps``
    times: max |difference| of the outputs and the KL, and in training of
    the gradients (after ``reduce_gradients``, relative to the largest
    gradient) and the BatchNorm running statistics; whether the
    generators agree after."""
    import torch

    from bayesian_torch_tpu_torch.parallel import (make_mesh, mc_forward,
                                                   reduce_gradients,
                                                   shard_batch)

    mesh = make_mesh(mc=mc, data=data)
    ref, net = (small_net(estimator, dropout=dropout) for _ in range(2))
    for m in (ref, net):
        m.train(training)
    x, y = _batch()
    diffs = {"outs": 0.0, "kl": 0.0, "grad": 0.0, "stats": 0.0}
    for _ in range(steps):
        want, kl_want = mc_forward(ref, x, num_mc, **kw)
        got, kl_got = mc_forward(net, shard_batch(x, mesh), num_mc,
                                 mesh=mesh, **kw)
        diffs["shape"] = tuple(got.shape)
        diffs["outs"] = max(diffs["outs"],
                            float((got - want).abs().max()))
        diffs["kl"] = max(diffs["kl"], float((kl_got - kl_want).abs()))
        if training:
            for m, outs, kl in ((ref, want, kl_want), (net, got, kl_got)):
                m.zero_grad()
                loss = _loss(outs if outs.dim() == 3 else outs[None], kl,
                             y)
                loss.backward()
            reduce_gradients(net, mesh)
            # relative to the model's largest gradient: a conv bias before
            # BatchNorm has a data gradient of rounding noise alone
            scale = max(float(p.grad.abs().max()) for p in ref.parameters())
            for p, q in zip(ref.parameters(), net.parameters()):
                diffs["grad"] = max(diffs["grad"], float(
                    (p.grad - q.grad).abs().max()) / scale)
            for a, b in zip(ref.buffers(), net.buffers()):
                diffs["stats"] = max(diffs["stats"], float(
                    (a.double() - b.double()).abs().max()))
    diffs["generators"] = torch.equal(ref.conv.generator.get_state(),
                                      net.conv.generator.get_state())
    return diffs


def mc_parity_error(rank, world, num_mc):
    """The error of ``mc_forward`` with ``num_mc`` draws over an 'mc'
    axis of ``world``."""
    from bayesian_torch_tpu_torch.parallel import make_mesh, mc_forward

    try:
        mc_forward(small_net(), _batch()[0], num_mc,
                   mesh=make_mesh(mc=world))
    except ValueError as e:
        return str(e)
    return "no error"


def tp_layer(kind, seed=0):
    """A narrow layer of ``kind`` (``TP_KINDS``) on a generator seeded
    ``seed``."""
    import torch

    from bayesian_torch_tpu_torch import layers as L

    gen = torch.Generator().manual_seed(seed)
    return {
        "linear": lambda: L.LinearReparameterization(16, 8, generator=gen),
        "conv": lambda: L.Conv2dReparameterization(8, 16, 3, padding=1,
                                                   generator=gen),
        "convT": lambda: L.ConvTranspose2dReparameterization(4, 8, 3,
                                                             generator=gen),
        "conv_flipout": lambda: L.Conv2dFlipout(8, 16, 3, padding=1,
                                                generator=gen),
        "linear_flipout": lambda: L.LinearFlipout(16, 8, generator=gen),
    }[kind]()


def tp_parity(rank, world, kind, arrays, x, eps):
    """A layer sharded over a 'model' axis of ``world`` ranks against the
    replicated layer, both loaded with ``arrays`` (torch-key -> numpy):
    the outputs with the injected noise ``eps`` (numpy keyword args), with
    noise drawn from the generator, under ``mc_forward``'s vmap emission
    in training mode (the shards' gradients against the replicated
    gradients' slices), and through the draw loop's presample in eval. Returns the count, the injected output
    and the differences."""
    import numpy as np
    import torch

    from bayesian_torch_tpu_torch.parallel import (make_mesh, mc_forward,
                                                   shard_params_tp)

    def build():
        layer = tp_layer(kind)
        if arrays:
            layer.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in arrays.items()}, strict=False)
        return layer

    ref, layer = build(), build()
    mesh = make_mesh(mc=1, data=1, model=world)
    count = shard_params_tp(layer, mesh)
    x = torch.from_numpy(x)
    kw = {k: torch.from_numpy(v) for k, v in eps.items()}
    got, kl = layer(x, **kw)
    want, kl_want = ref(x, **kw)
    diffs = {"count": count, "out": got.detach().numpy(),
             "kl": float(kl), "injected": float((got - want).abs().max()),
             "injected_kl": abs(float(kl) - float(kl_want))}
    got, _ = layer(x)
    want, _ = ref(x)
    diffs["drawn"] = float((got - want).abs().max())
    class Flat(torch.nn.Module):
        def __init__(self, layer):
            super().__init__()
            self.layer = layer

        def forward(self, x):
            out, kl = self.layer(x)
            return out.flatten(1), kl

    for m in (ref, layer):
        m.train()
        m.zero_grad()
        outs, kl = mc_forward(Flat(m), x, 2, emission="vmap")
        (outs.square().mean() + kl).backward()
        diffs.setdefault("vmap_outs", []).append(outs.detach())
    diffs["vmap"] = float((diffs["vmap_outs"][0]
                           - diffs.pop("vmap_outs")[1]).abs().max())
    with torch.no_grad():  # eval: the draw loop's presample
        loop = [mc_forward(Flat(m.eval()), x, 2, return_kl=False)
                for m in (ref, layer)]
        diffs["loop"] = float((loop[0] - loop[1]).abs().max())
    grad = 0.0
    tp = layer._tp
    for name, p in layer.named_parameters():
        g = getattr(ref, name).grad
        if name in tp.dims:
            g = tp.take(g, tp.dims[name])
        grad = max(grad, float((p.grad - g).abs().max())
                   / (float(g.abs().max()) or 1.0))
    diffs["grad"] = grad
    diffs["shapes"] = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    return {k: (v if not isinstance(v, np.ndarray) or rank == 0 else None)
            for k, v in diffs.items()}


def mesh_layout(rank, world):
    """This rank's coordinates and groups' sizes on a (2, world // 2)
    mesh and on a (2, 1, world // 2) mesh with a 'model' axis; the
    ``shard_batch`` block of ``arange``; ``replicate`` of rank-dependent
    parameters, buffers and generator states."""
    import numpy as np
    import torch

    from bayesian_torch_tpu_torch.parallel import (make_mesh, replicate,
                                                   shard_batch)
    from bayesian_torch_tpu_torch.parallel._comm import group_size

    out = {}
    mesh = make_mesh(mc=2)
    out["shape"] = dict(mesh.shape)
    out["coords"] = dict(mesh.coords)
    out["groups"] = {"mc": group_size(mesh.group("mc")),
                     "data": group_size(mesh.group("data")),
                     "all": group_size(mesh.group())}
    out["block"] = shard_batch(np.arange(world * 3), mesh).tolist()
    tp = make_mesh(mc=2, data=1, model=world // 2)
    out["tp_shape"] = dict(tp.shape)
    out["tp_coords"] = dict(tp.coords)
    layer = small_net(seed=rank)
    with torch.no_grad():
        layer.bn.running_mean.fill_(float(rank))
    replicate(layer, mesh)
    want = small_net(seed=0)
    out["replicated"] = all(torch.equal(a, b) for a, b in zip(
        layer.state_dict().values(), want.state_dict().values()))
    out["generator"] = torch.equal(layer.conv.generator.get_state(),
                                   want.conv.generator.get_state())
    return out


def tp_counts(rank, world):
    """``shard_params_tp`` over a 'model' axis of ``world`` ranks: the
    count on each model of ``tp_models``, and max |difference| of the
    sharded resnet20's MC-2 logits from the replicated one's, in eval (the
    draw loop's presample) and through the vmap emission in training."""
    import torch

    from bayesian_torch_tpu_torch.parallel import (make_mesh, mc_forward,
                                                   shard_params_tp)

    mesh = make_mesh(mc=1, data=1, model=world)
    counts = {name: shard_params_tp(build(), mesh)
              for name, build in tp_models().items()}
    x = torch.randn((4, 3, 8, 8), generator=torch.Generator().manual_seed(1))
    diffs = {}
    for mode in ("eval", "train"):
        ref = tp_models()["resnet20"]().train(mode == "train")
        model = tp_models()["resnet20"]().train(mode == "train")
        shard_params_tp(model, mesh)
        with torch.no_grad():
            want = mc_forward(ref, x, 2, return_kl=False)
            got = mc_forward(model, x, 2, return_kl=False)
        diffs[mode] = float((got - want).abs().max())
    return counts, diffs


def tp_models():
    """Narrow models for the count: the JAX test's layers, deterministic
    torch layers, a BatchNorm, and the CIFAR resnet20."""
    import torch
    from torch import nn

    from bayesian_torch_tpu_torch import layers as L
    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational import (
        resnet20,
    )

    def gen():
        return torch.Generator().manual_seed(0)

    return {
        "linear": lambda: L.LinearReparameterization(16, 8, generator=gen()),
        "conv": lambda: L.Conv2dReparameterization(8, 16, 3,
                                                   generator=gen()),
        "convT": lambda: L.ConvTranspose2dReparameterization(
            8, 16, 3, generator=gen()),
        "odd_linear": lambda: L.LinearReparameterization(16, 7,
                                                         generator=gen()),
        "nn_linear": lambda: nn.Linear(16, 8),
        "bn": lambda: L.BatchNorm2dLayer(8),
        "resnet20": lambda: resnet20(generator=gen()),
    }


def small_mnist(data_dir=None, synthetic=False):
    """test_torch_port_examples.py's small synthetic MNIST."""
    from bayesian_torch_tpu_torch.examples import _data as tdata

    return (tdata._synthetic(32, (1, 28, 28), 10, 0, proto_seed=100),
            tdata._synthetic(16, (1, 28, 28), 10, 1, proto_seed=100))


def run_mnist_trainer(argv):
    """``main_bayesian_mnist.main(argv)`` on ``small_mnist``: (metrics,
    the model's final state as numpy)."""
    from bayesian_torch_tpu_torch.examples import main_bayesian_mnist as m

    built = []
    scnn = m.SCNN
    m.load_mnist = small_mnist
    m.SCNN = lambda **kw: built.append(scnn(**kw)) or built[-1]
    try:
        metrics = m.main(argv)
    finally:
        m.SCNN = scnn
    return metrics, {k: v.detach().numpy().copy()
                     for k, v in built[0].state_dict().items()}


def trainer_run(rank, world, save_dir, argv):
    """The MNIST trainer under this world (``--mesh-mc`` in ``argv``),
    each rank in ``<save_dir>/r<rank>``: the metrics, the final weights
    and the files the rank wrote."""
    import os

    out = os.path.join(save_dir, f"r{rank}")
    metrics, state = run_mnist_trainer(argv + [f"--save_dir={out}"])
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    return {"metrics": metrics, "state": state, "files": files}
