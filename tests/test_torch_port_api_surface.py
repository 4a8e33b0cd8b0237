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


@pytest.mark.parametrize("first", [
    "bayesian_torch_tpu_torch.utils",
    "bayesian_torch_tpu_torch.ao.quantization",
    "bayesian_torch_tpu_torch.layers.variational_layers",
    "bayesian_torch_tpu_torch.quantization"])
def test_package_imports_on_its_own(first):
    """``utils`` and ``ao.quantization`` raised a circular ImportError when
    imported first; ``ao/quantization/quantize.py`` now imports the layers
    and ``bnn_to_qbnn`` inside its functions."""
    proc = subprocess.run([sys.executable, "-c", f"import {first}"],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
