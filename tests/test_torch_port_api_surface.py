"""Public import-path parity of the port with the JAX package: the twin of
``tests/test_api_surface.py`` with the package prefix swapped, so that
``s/bayesian_torch_tpu/bayesian_torch_tpu_torch/`` ports an import 1:1.
Also: each package of the port imports on its own, as a user's first
import (the package inits import one another in a cycle that only some
entry points used to survive)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest


def test_variational_layers_namespace():
    from bayesian_torch_tpu_torch.layers.variational_layers import (  # noqa: F401,E501
        BaseVariationalLayer_,
        Conv1dReparameterization,
        Conv2dReparameterization,
        Conv3dReparameterization,
        ConvTranspose1dReparameterization,
        ConvTranspose2dReparameterization,
        ConvTranspose3dReparameterization,
        HistogramObserver,
        LinearReparameterization,
        LSTMReparameterization,
        MinMaxObserver,
        PerChannelMinMaxObserver,
        QConfig,
        QuantizedConv1dReparameterization,
        QuantizedConv2dReparameterization,
        QuantizedConv3dReparameterization,
        QuantizedConvTranspose1dReparameterization,
        QuantizedConvTranspose2dReparameterization,
        QuantizedConvTranspose3dReparameterization,
        QuantizedLinearReparameterization,
    )


def test_flipout_layers_namespace():
    from bayesian_torch_tpu_torch.layers.flipout_layers import (  # noqa: F401
        BaseVariationalLayer_,
        Conv1dFlipout,
        Conv2dFlipout,
        Conv3dFlipout,
        ConvTranspose1dFlipout,
        ConvTranspose2dFlipout,
        ConvTranspose3dFlipout,
        LinearFlipout,
        LSTMFlipout,
        QuantizedConv1dFlipout,
        QuantizedConv2dFlipout,
        QuantizedConv3dFlipout,
        QuantizedConvTranspose1dFlipout,
        QuantizedConvTranspose2dFlipout,
        QuantizedConvTranspose3dFlipout,
        QuantizedLinearFlipout,
    )


def test_bnn_to_qbnn_qbatchnorm_name():
    from bayesian_torch_tpu_torch.layers.batchnorm import (
        QuantizedBatchNorm2d,
    )
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import QBatchNorm2d

    assert QBatchNorm2d is QuantizedBatchNorm2d


def test_avuc_auc_matches_sklearn():
    from bayesian_torch_tpu_torch.utils.avuc_loss import auc

    sklearn = pytest.importorskip("sklearn.metrics")
    x = np.array([0.0, 0.25, 0.5, 1.0])
    y = np.array([1.0, 0.8, 0.9, 0.2])
    assert float(auc(x, y)) == pytest.approx(sklearn.auc(x, y), abs=1e-6)
    assert float(auc(x[::-1].copy(), y[::-1].copy())) == pytest.approx(
        sklearn.auc(x[::-1], y[::-1]), abs=1e-6)


def test_same_name_same_class_across_paths():
    import bayesian_torch_tpu_torch.layers as L
    import bayesian_torch_tpu_torch.layers.flipout_layers as FL
    import bayesian_torch_tpu_torch.layers.variational_layers as VL

    for name in ("LinearReparameterization", "Conv2dReparameterization",
                 "QuantizedConv2dReparameterization",
                 "LSTMReparameterization", "HistogramObserver"):
        assert getattr(L, name) is getattr(VL, name)
    for name in ("LinearFlipout", "Conv2dFlipout", "QuantizedLinearFlipout",
                 "LSTMFlipout"):
        assert getattr(L, name) is getattr(FL, name)


def test_parallel_and_data_namespaces():
    """The JAX package's ``parallel`` and ``data`` imports, the prefix
    swapped (``from bayesian_torch_tpu.parallel import make_mesh, ...``,
    ``from bayesian_torch_tpu.data import DataLoader``)."""
    import bayesian_torch_tpu.parallel as jpar
    from bayesian_torch_tpu_torch.data import DataLoader  # noqa: F401
    from bayesian_torch_tpu_torch.data.loader import (  # noqa: F401
        native_available,
    )
    import bayesian_torch_tpu_torch.parallel as tpar
    from bayesian_torch_tpu_torch.parallel import (  # noqa: F401
        initialize,
        make_mesh,
        mc_forward,
        mc_vmap,
        replicate,
        shard_batch,
        shard_params_tp,
    )
    from bayesian_torch_tpu_torch.parallel.distributed import (  # noqa: F401
        initialize as initialize_,
    )
    from bayesian_torch_tpu_torch.parallel.mesh import (  # noqa: F401
        make_mesh as make_mesh_,
    )
    from bayesian_torch_tpu_torch.parallel.tp import (  # noqa: F401
        shard_params_tp as shard_params_tp_,
    )

    public = {n for n in dir(jpar) if not n.startswith("_")
              and callable(getattr(jpar, n))}
    assert public <= set(dir(tpar)), public - set(dir(tpar))


def test_package_inits_reexport_as_jax():
    """``bayesian_torch_tpu/__init__.py`` re-exports ``prepare`` and
    ``convert``, ``bayesian_torch_tpu/ops/__init__.py`` ``gaussian_kl``,
    ``sample_gaussian_weight`` and ``sigma_from_rho``: so do the port's,
    the same objects as their modules'."""
    import bayesian_torch_tpu as jpkg
    import bayesian_torch_tpu.ops as jops
    import bayesian_torch_tpu_torch.ops.kl as kl
    import bayesian_torch_tpu_torch.ops.sampling as sampling
    import bayesian_torch_tpu_torch.quantization as quantization
    from bayesian_torch_tpu_torch import convert, prepare
    from bayesian_torch_tpu_torch.ops import (gaussian_kl,
                                              sample_gaussian_weight,
                                              sigma_from_rho)

    assert (prepare, convert) == (quantization.prepare, quantization.convert)
    assert gaussian_kl is kl.gaussian_kl
    assert sample_gaussian_weight is sampling.sample_gaussian_weight
    assert sigma_from_rho is sampling.sigma_from_rho
    for pkg, port in ((jpkg, "bayesian_torch_tpu_torch"),
                      (jops, "bayesian_torch_tpu_torch.ops")):
        names = {n for n in dir(pkg) if not n.startswith("_")
                 and callable(getattr(pkg, n))}
        assert names <= set(dir(sys.modules[port])), names


def test_rademacher_takes_a_generator():
    """``ops.sampling.rademacher`` (JAX: a key, here a generator): iid
    signs in {-1, +1} of the asked shape and dtype, the same for the same
    generator state, balanced within 4 standard errors."""
    import torch

    from bayesian_torch_tpu_torch.ops.sampling import rademacher

    signs = rademacher(torch.Generator().manual_seed(3), (64, 128),
                       torch.bfloat16)
    assert signs.shape == (64, 128) and signs.dtype == torch.bfloat16
    assert set(signs.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(signs, rademacher(torch.Generator().manual_seed(3),
                                         (64, 128), torch.bfloat16))
    assert abs(float(signs.float().mean())) < 4 / signs.numel() ** 0.5


@pytest.mark.parametrize("first", [
    "bayesian_torch_tpu_torch.utils",
    "bayesian_torch_tpu_torch.ao.quantization",
    "bayesian_torch_tpu_torch.layers.variational_layers",
    "bayesian_torch_tpu_torch.quantization",
    "bayesian_torch_tpu_torch.parallel",
    "bayesian_torch_tpu_torch.data"])
def test_package_imports_on_its_own(first):
    """``utils`` and ``ao.quantization`` raised a circular ImportError when
    imported first; ``ao/quantization/quantize.py`` now imports the layers
    and ``bnn_to_qbnn`` inside its functions."""
    proc = subprocess.run([sys.executable, "-c", f"import {first}"],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# every class and function whose JAX twin takes ``data_format``, by module
_DATA_FORMAT = {
    "ops.conv": ["conv_nd", "conv_transpose_nd", "_apply_conv",
                 "sampled_conv", "flipout_conv"],
    "ops.int8": ["qconv"],
    "nn.functional": ["max_pool_nd", "avg_pool_nd", "adaptive_avg_pool_nd"],
    "nn.modules": ["MaxPool2d", "AdaptiveAvgPool2d", "Conv1d", "Conv2d",
                   "Conv3d", "ConvTranspose1d", "ConvTranspose2d",
                   "ConvTranspose3d", "BatchNorm1d", "BatchNorm2d",
                   "BatchNorm3d"],
    "layers": [f"{kind}{nd}d{est}" for kind in ("Conv", "ConvTranspose",
                                                "QuantizedConv",
                                                "QuantizedConvTranspose")
               for nd in (1, 2, 3) for est in ("Reparameterization",
                                               "Flipout")]
    + ["BatchNorm1dLayer", "BatchNorm2dLayer", "BatchNorm3dLayer",
       "QuantizedBatchNorm2d"],
    "models._large_resnet": ["LargeResNet", "BasicBlock", "Bottleneck"],
}


@pytest.mark.parametrize("module", list(_DATA_FORMAT))
def test_data_format_keyword_as_jax(module):
    """Each of these takes ``data_format`` in the JAX package (asserted, so
    the list follows JAX) and in the port, defaulting to "NCHW"; the
    ImageNet factories pass it on."""
    import importlib
    import inspect

    jmod = importlib.import_module(f"bayesian_torch_tpu.{module}")
    tmod = importlib.import_module(f"bayesian_torch_tpu_torch.{module}")
    for name in _DATA_FORMAT[module]:
        for mod in (jmod, tmod):
            obj = getattr(mod, name)
            # a class's constructor (nnx's metaclass hides it from the
            # class's own signature)
            params = inspect.signature(obj.__init__ if inspect.isclass(obj)
                                       else obj).parameters
            assert "data_format" in params, (mod.__name__, name)
            assert params["data_format"].default == "NCHW", (mod.__name__,
                                                             name)
    if module == "models._large_resnet":
        from bayesian_torch_tpu_torch.models.bayesian import (
            resnet_variational_large as rvl,
        )
        model = rvl.resnet18(num_classes=4, data_format="NHWC")
        assert model.data_format == "NHWC" == model.layer4[1].bn2.data_format
