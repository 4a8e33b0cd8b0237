"""Dataset helpers of the example trainers (counterpart of
``bayesian_torch_tpu/examples/_data.py``; so far the ImageNet loader).

Numpy only, with the JAX module's seeds: the same arguments give the same
arrays (the JAX module also caps the synthetic set at ``BTT_SYNTH_TEST_N``
examples, 1024 unless set; the port's tests shrink it by their own means). ``batches`` is the epoch iterator both the trainers and the engine
use: the JAX engine's C++ loader lives in ``bayesian_torch_tpu.data``,
whose package imports JAX, which the port never does.
"""

from __future__ import annotations

import os

import numpy as np


def _synthetic(n, shape, num_classes, seed, proto_seed=1234):
    """Class-conditional Gaussian blobs: learnable but trivial.

    Class prototypes come from ``proto_seed`` (shared between the splits
    of a dataset); ``seed`` drives the labels and per-example noise.
    """
    protos = np.random.RandomState(proto_seed).randn(
        num_classes, *shape).astype(np.float32)
    rs = np.random.RandomState(seed)
    y = rs.randint(0, num_classes, size=n).astype(np.int32)
    x = 0.6 * protos[y] + 0.8 * rs.randn(n, *shape).astype(np.float32)
    return x, y


def load_imagenet_val(data_dir=None, synthetic=False, n=256, img=224,
                      num_classes=1000):
    """Validation-style loader: ``<data_dir>/imagenet_val.npz`` (keys x,
    y) unless ``synthetic``, else the synthetic set of the JAX loader."""
    if not synthetic and data_dir:
        path = os.path.join(data_dir, "imagenet_val.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return z["x"].astype(np.float32), z["y"].astype(np.int32)
    return _synthetic(n, (3, img, img), num_classes, 4, proto_seed=300)


def batches(x, y, batch_size, *, shuffle=True, seed=0, drop_last=True):
    """Epoch iterator over host numpy arrays."""
    n = x.shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        sel = idx[i:i + batch_size]
        yield x[sel], y[sel]
