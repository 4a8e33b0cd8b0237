"""The noise conventions of the Bayesian layers, written out in plain
torch: the counter-hash normal, the splitmix32 sign, the salts and the
64-bit seeds drawn from a CPU ``torch.Generator``.

These are the published conventions of the JAX package and its port
(``ops/sampling.py`` there), frozen here so that the reference draws the
same noise without calling either. Every value is a pure function of
integers: a 64-bit seed, a draw index and the flat element index.

- normal i of a stream with salt ``t``: Box-Muller on the top 24 bits of
  splitmix32(t + (i+1) * GOLDEN) and of splitmix32((t ^ 0xDEADBEEF) +
  (i+1) * GOLDEN);
- sign i: -1 where bit 31 of splitmix32(t + (i+1) * GOLDEN) is set;
- draw s of a launch of n elements a draw under seed q takes the salt
  ``seed_salt(q, 0) + s * n * GOLDEN``, so its elements are counters
  s*n .. s*n + n - 1 of one stream;
- the Flipout sign salts of draw s are ``seed_salt(q, 2s)`` (input) and
  ``seed_salt(q, 2s + 1)`` (output).
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SALT2_XOR = 0xDEADBEEF
U24 = 1.0 / (1 << 24)

# elements hashed at once: int64 temporaries of 8 bytes, a few alive
CHUNK = 1 << 26


def splitmix32(x):
    """splitmix32's finalizer on uint32 values: a Python int, or an int64
    tensor (changed in place)."""
    x ^= x >> 16
    x *= 0x7FEB352D
    x &= M32
    x ^= x >> 15
    x *= 0x846CA68B
    x &= M32
    x ^= x >> 16
    return x


def seed_salt(seed: int, k: int) -> int:
    lo, hi = seed & M32, (seed >> 32) & M32
    return splitmix32(lo ^ splitmix32((hi + (k + 1) * GOLDEN) & M32))


def draw_salt(seed: int, s: int, n: int) -> int:
    return (seed_salt(seed, 0) + s * n * GOLDEN) & M32


def sign_salts(seed: int, s: int):
    return seed_salt(seed, 2 * s), seed_salt(seed, 2 * s + 1)


def draw_seed(gen: torch.Generator) -> int:
    """The 63-bit seed a layer takes from its CPU generator for a call."""
    return int(torch.randint(0, 2**63 - 1, (), generator=gen))


def _hash(salt: int, start: int, n: int, device):
    h = torch.arange(start + 1, start + n + 1, dtype=torch.int64,
                     device=device)
    h *= GOLDEN
    h += salt
    h &= M32
    return splitmix32(h)


def normals(salt: int, start: int, n: int, device) -> torch.Tensor:
    """Normals start .. start + n - 1 of the stream ``salt``, f32."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for at in range(0, n, CHUNK):
        m = min(CHUNK, n - at)
        h1 = _hash(salt, start + at, m, device)
        u1 = (h1 >> 8).to(torch.float32) * U24 + U24 * 0.5
        del h1
        h2 = _hash(salt ^ SALT2_XOR, start + at, m, device)
        u2 = (h2 >> 8).to(torch.float32) * U24
        del h2
        out[at:at + m] = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            2.0 * math.pi * u2)
    return out


def signs(salt: int, shape, device) -> torch.Tensor:
    """Signs 0 .. numel - 1 of the stream ``salt`` over ``shape`` (its
    flat order), f32 in {-1, +1}."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for at in range(0, n, CHUNK):
        m = min(CHUNK, n - at)
        h = _hash(salt, at, m, device)
        out[at:at + m] = 1.0 - 2.0 * (h >> 31).to(torch.float32)
    return out.reshape(shape)
