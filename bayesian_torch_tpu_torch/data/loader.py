"""Native prefetching DataLoader (counterpart of
``bayesian_torch_tpu/data/loader.py``): a ctypes binding of the port's own
copy of ``csrc/loader.cpp``.

Per-epoch shuffling, multi-threaded batch gather with the normalisation
``(x - shift) * scale`` fused into the gather, and a bounded prefetch
buffer, so host batch preparation overlaps the card's work. The epoch
order is the C++ one: ``std::mt19937_64(seed + epoch_seed * 0x9E3779B9)``
and a Fisher-Yates pass, so a trainer of the port sees the batches the JAX
trainer sees at the same seed.

The library is compiled with ``g++`` at first use into the git-ignored
``bayesian_torch_tpu_torch/_build/``, named by a hash of the source and
flags (as ``ops/cuda/_build.py`` names the CUDA library), through a
temporary file and a rename, so concurrent builders do not collide. When
``g++`` or the build fails the loader warns once, naming the error, and
iterates with numpy (``_numpy_epoch``: JAX's fallback, whose shuffled
order is ``RandomState(seed + epoch_seed)``'s and not the native one);
``native_available()`` says which path runs.

Usage:
    loader = DataLoader(x, y, batch_size=128, shuffle=True,
                        num_workers=4, scale=1/0.3081, shift=0.1307)
    for epoch in range(E):
        for xb, yb in loader.epoch(epoch_seed=epoch):
            step(torch.from_numpy(xb), torch.from_numpy(yb))
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIB = None
_ERROR = None  # the build or load failure, once there was one
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return _BUILD_DIR / f"btt_loader_{digest.hexdigest()[:16]}.so"


def _build_lib(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build loses nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_lib():
    """The loaded library; raises (and remembers why) when it cannot be
    built or loaded."""
    global _LIB, _ERROR
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise _ERROR
        try:
            path = library_path()
            if not path.exists():
                _build_lib(path)
            lib = ctypes.CDLL(str(path))
        except Exception as e:  # noqa: BLE001 - reported, then re-raised
            _ERROR = e
            warnings.warn(
                "bayesian_torch_tpu_torch.data: the native loader could "
                f"not be built or loaded ({type(e).__name__}: {e}); "
                "batches come from the numpy path, whose shuffled order "
                "differs from the native one", RuntimeWarning, stacklevel=3)
            raise
        lib.bt_loader_create.restype = ctypes.c_void_p
        lib.bt_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
            ctypes.c_int64,
        ]
        lib.bt_loader_num_batches.restype = ctypes.c_int64
        lib.bt_loader_num_batches.argtypes = [ctypes.c_void_p]
        lib.bt_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int64]
        lib.bt_loader_next.restype = ctypes.c_int64
        lib.bt_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.bt_loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def native_available() -> bool:
    """True when the C++ loader is built and loaded (building it now if
    needed); False, after one warning naming the error, otherwise."""
    try:
        _load_lib()
        return True
    except Exception:  # noqa: BLE001 - the warning named it
        return False


class DataLoader:
    """Threaded, shuffling, prefetching batch iterator over host arrays.

    ``x``: float32 array (N, ...); ``y``: int labels (N,) or None.
    ``scale``/``shift`` apply ``(x - shift) * scale`` in the worker
    threads (fused into the gather pass). Batches are numpy arrays.
    """

    def __init__(self, x, y=None, *, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 scale: float = 1.0, shift: float = 0.0, seed: int = 0,
                 queue_depth: int = 4):
        self.x = np.ascontiguousarray(np.asarray(x, np.float32))
        self.y = (np.ascontiguousarray(np.asarray(y, np.int32))
                  if y is not None else None)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.scale = float(scale)
        self.shift = float(shift)
        self.seed = int(seed)
        self.item_shape = self.x.shape[1:]
        self.item_size = int(np.prod(self.item_shape)) if self.item_shape \
            else 1
        self._handle = None
        self._lib = _load_lib() if native_available() else None
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.bt_loader_create(
                self.x.ctypes.data_as(ctypes.c_void_p),
                (self.y.ctypes.data_as(ctypes.c_void_p)
                 if self.y is not None else None),
                self.x.shape[0], self.item_size, self.batch_size,
                1 if shuffle else 0, 1 if drop_last else 0,
                self.scale, self.shift, self.seed, queue_depth))

    def __len__(self):
        n = self.x.shape[0]
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def epoch(self, epoch_seed: int = 0):
        """Iterate one epoch of (x_batch, y_batch) numpy arrays; the order
        is a pure function of (``seed``, ``epoch_seed``)."""
        if self._lib is None:
            yield from self._numpy_epoch(epoch_seed)
            return
        self._lib.bt_loader_start_epoch(self._handle, self.num_workers,
                                        int(epoch_seed))
        out_x = np.empty((self.batch_size,) + self.item_shape, np.float32)
        out_y = np.empty((self.batch_size,), np.int32)
        while True:
            got = self._lib.bt_loader_next(
                self._handle, out_x.ctypes.data_as(ctypes.c_void_p),
                out_y.ctypes.data_as(ctypes.c_void_p))
            if got < 0:
                return
            yield out_x[:got].copy(), out_y[:got].copy()

    def __iter__(self):
        return self.epoch(0)

    def _numpy_epoch(self, epoch_seed):
        """The numpy path, with the JAX package's semantics: shuffled by
        ``RandomState(seed + epoch_seed)``, which is not the native
        order."""
        n = self.x.shape[0]
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_seed).shuffle(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for i in range(0, end, self.batch_size):
            sel = idx[i:i + self.batch_size]
            xb = self.x[sel]
            if self.scale != 1.0 or self.shift != 0.0:
                xb = (xb - self.shift) * self.scale
            yb = self.y[sel] if self.y is not None else \
                np.zeros(len(sel), np.int32)
            yield xb, yb

    def __del__(self):
        if self._lib is not None and self._handle:
            self._lib.bt_loader_destroy(self._handle)
            self._handle = None
