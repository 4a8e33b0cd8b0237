"""Build and load the package's CUDA kernels (no JAX counterpart).

``nvcc`` compiles every ``csrc/*.cu`` of this package for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, at first use, into
``bayesian_torch_tpu_torch/_build/`` (git-ignored). A hash of the sources
and flags names the library, so an unchanged tree builds once. The
library is loaded with ``ctypes``; each C entry point returns the launch's
``cudaGetLastError()``, which ``check`` turns into an exception.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # mu, sigma (or rho), in_bf16, out, n, num_samples, seed, the seed in
    # device memory (or NULL), out_bf16, rho_mode, lane0, lane stride,
    # offset, stream
    "btt_sample_scaled_normals_batch": (_P, _P, ctypes.c_int, _P,
                                        ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_uint64, _P, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64, _P),
    # x, x lane stride, mu, sigma, out, S, M, N, K, seed, lane0, lane
    # stride, offset, stream
    "btt_sampled_matmul": (_P, ctypes.c_int64, _P, _P, _P, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, _P),
    # g, g_bf16, rho (or NULL), rho_bf16, out, n, num_samples, seed,
    # lane0, lane stride, offset, stream
    "btt_sampled_weights_bwd": (_P, ctypes.c_int, _P, ctypes.c_int, _P,
                                ctypes.c_int64, ctypes.c_int,
                                ctypes.c_uint64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64, _P),
    # g, mu, sigma, dx, S, M, N, K, seed, lane0, lane stride, offset,
    # stream
    "btt_sampled_matmul_dx": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                              ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, _P),
    # g, x, x lane stride, x_bf16, dmu, dsigma, S, M, N, K, seed, lane0,
    # lane stride, offset, stream
    "btt_sampled_matmul_dw": (_P, _P, ctypes.c_int64, ctypes.c_int, _P, _P,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int64, _P),
    # x, w, corr (or NULL), bias (or NULL), out, M, N, K, mult, out_zp,
    # stream
    "btt_qmatmul_requant": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_float, ctypes.c_float,
                            _P),
    # the same, then the Flipout epilogue's arguments, stream
    "btt_qmatmul_requant_flipout": (_P, _P, _P, _P, _P, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_float, _P, _P),
    # x, w, bias (or NULL), y, dtype code, B, S, O, C, P, w row length,
    # x batch stride, x lane stride, w lane stride, bias lane stride, xvec,
    # wvec, stream
    "btt_mc_gemm": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int, _P),
    # x, w, bias (or NULL), y, dtype code, M, S, O, C, w row length, x row
    # stride, x lane stride, w lane stride, y row stride, y lane stride,
    # bias lane stride, 16-byte stores of y, stream
    "btt_mc_gemm_cl": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, _P),
    # x (or NULL: write the signs), y, float bits, the bits of 1.0,
    # geometry, stream
    "btt_sign_flip": (_P, _P, ctypes.c_int, ctypes.c_uint64, _P, _P),
    # mean, pert, y, dtype code, geometry, stream
    "btt_sign_combine": (_P, _P, _P, ctypes.c_int, _P, _P),
    # a, y, a zero point, centred uint8 of +1 and of -1, multiplier, out
    # zero point, x_q (or NULL: no requantize), the payload's zero point,
    # the requantize's multiplier and zero point, geometry, stream
    "btt_qsign_mul": (_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, _P, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, _P, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"btt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels if the library is missing.

    Returns (library path, seconds spent compiling, compiler output);
    seconds is 0.0 when the library was already built.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in _sources():
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            with open(tmp / f"{src.stem}.log", "w") as log:
                proc = subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, obj, proc))
        logs, failed = [], []
        for cmd, obj, proc in jobs:
            proc.wait()
            text = (tmp / f"{obj.stem}.log").read_text()
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = tmp / "lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
               *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent build loses nothing
    log = "".join(logs) + proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return out, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.btt_error_string.argtypes = (ctypes.c_int,)
    lib.btt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = lib.btt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
