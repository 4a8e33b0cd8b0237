"""Dataset helpers of the example trainers (counterpart of
``bayesian_torch_tpu/examples/_data.py``).

Numpy only, with the JAX module's seeds and caps: the same arguments give
the same arrays. Each loader reads ``<data_dir>/<name>.npz`` when it
exists (mnist.npz or cifar10.npz with x_train, y_train, x_test, y_test;
imagenet_val.npz with x, y) and ``synthetic`` is not set, and otherwise
makes a synthetic set: class-conditional Gaussian blobs of the right
shape, learnable but trivial. As in the JAX module, a synthetic set holds
at most ``BTT_SYNTH_TRAIN_N`` (default 4096) training and
``BTT_SYNTH_TEST_N`` (default 1024) test examples, read from the
environment when the module is imported. ``batches`` is the epoch
iterator both the trainers and the engine use: the JAX engine's C++
loader lives in ``bayesian_torch_tpu.data``, whose package imports JAX,
which the port never does.
"""

from __future__ import annotations

import os

import numpy as np

_SYNTH_TRAIN_CAP = int(os.environ.get("BTT_SYNTH_TRAIN_N", 4096))
_SYNTH_TEST_CAP = int(os.environ.get("BTT_SYNTH_TEST_N", 1024))


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


def _try_npz(data_dir, name, keys=("x_train", "y_train", "x_test",
                                   "y_test")):
    """The arrays ``keys`` of ``<data_dir>/<name>``, or None when there is
    no such file."""
    if not data_dir:
        return None
    path = os.path.join(data_dir, name)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return tuple(z[k] for k in keys)


def _normalised(got, shape, mean, std):
    """(train, test) of an npz split: images reshaped to (N, *shape),
    scaled to [0, 1] when they are bytes, normalised by the reference's
    per-channel mean and std; int32 labels."""
    x_tr, y_tr, x_te, y_te = got
    x_tr = x_tr.reshape((-1,) + shape).astype(np.float32)
    x_te = x_te.reshape((-1,) + shape).astype(np.float32)
    if x_tr.max() > 2.0:
        x_tr, x_te = x_tr / 255.0, x_te / 255.0
    mean = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(std, np.float32).reshape(1, -1, 1, 1)
    return (((x_tr - mean) / std, y_tr.astype(np.int32)),
            ((x_te - mean) / std, y_te.astype(np.int32)))


def load_mnist(data_dir=None, synthetic=False, n_train=60000, n_test=10000):
    """((x_train, y_train), (x_test, y_test)), x (N, 1, 28, 28) f32 with
    the reference's normalisation (mean 0.1307, std 0.3081)."""
    if not synthetic:
        got = _try_npz(data_dir, "mnist.npz")
        if got is not None:
            return _normalised(got, (1, 28, 28), [0.1307], [0.3081])
    n_train = min(n_train, _SYNTH_TRAIN_CAP)
    n_test = min(n_test, _SYNTH_TEST_CAP)
    return (_synthetic(n_train, (1, 28, 28), 10, 0, proto_seed=100),
            _synthetic(n_test, (1, 28, 28), 10, 1, proto_seed=100))


def load_cifar10(data_dir=None, synthetic=False, n_train=50000,
                 n_test=10000):
    """((x_train, y_train), (x_test, y_test)), x (N, 3, 32, 32) f32 with
    the reference's per-channel normalisation."""
    if not synthetic:
        got = _try_npz(data_dir, "cifar10.npz")
        if got is not None:
            return _normalised(got, (3, 32, 32), [0.4914, 0.4822, 0.4465],
                               [0.2470, 0.2435, 0.2616])
    n_train = min(n_train, _SYNTH_TRAIN_CAP)
    n_test = min(n_test, _SYNTH_TEST_CAP)
    return (_synthetic(n_train, (3, 32, 32), 10, 2, proto_seed=200),
            _synthetic(n_test, (3, 32, 32), 10, 3, proto_seed=200))


def load_imagenet_val(data_dir=None, synthetic=False, n=256, img=224,
                      num_classes=1000):
    """Validation-style loader: ``<data_dir>/imagenet_val.npz`` (keys x,
    y) unless ``synthetic``, else the synthetic set of the JAX loader."""
    if not synthetic:
        got = _try_npz(data_dir, "imagenet_val.npz", keys=("x", "y"))
        if got is not None:
            x, y = got
            return x.astype(np.float32), y.astype(np.int32)
    return _synthetic(min(n, _SYNTH_TEST_CAP), (3, img, img), num_classes,
                      4, proto_seed=300)


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
