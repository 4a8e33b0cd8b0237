"""Weight-noise sampling primitives (counterpart of
``bayesian_torch_tpu/ops/sampling.py``).

Every random draw of the forward path is a pure function of integers:
one 64-bit seed per call, taken from the layer's CPU ``torch.Generator``
(``draw_seed``), a draw index ``s`` and the flat element index. The
counter-hash Box-Muller below (``normal_fused``) hashes the same integers
as the JAX package's generator, in int64-masked torch arithmetic, and it
is the generator the CUDA kernels in ``csrc/`` compute. So a kernel and
its plain version give the same eps, and a CPU test can hold the
generator against JAX's own ``normal_fused`` given the same salt (they
differ only in the last ulp of log and cos).

Counters are 32-bit, as in the JAX generator. The S draws of one launch
take consecutive windows of one salt's counter stream (``draw_salt``), so
their eps never repeat one another; draws of different launches come from
independent seeds, and two windows of n1 and n2 counters under two of them
overlap with probability (n1 + n2 - 1) / 2**32.

Because every draw comes from a layer's CPU generator, replaying those
generators replays the draws: ``replay_generators`` lets a checkpoint's
recompute (``ops/remat.py``) draw the weights, salts and Dropout masks
that its forward drew.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF
_SM32_GOLDEN = 0x9E3779B9  # splitmix increment (2^32 / golden ratio)
_SALT2_XOR = 0xDEADBEEF
_U24 = 1.0 / (1 << 24)
_TWO_PI = 2.0 * math.pi


def sigma_from_rho(rho):
    """sigma = softplus(rho) = log1p(exp(rho))."""
    return F.softplus(rho)


def log_sigma_from_rho(rho):
    """log(softplus(rho)) with the JAX package's asymptote branch.

    XLA flushes the subnormal softplus of rho << 0 to zero, so the JAX
    function switches to the asymptote log(softplus(rho)) -> rho below
    rho = -20. torch keeps subnormals and would give a slightly different
    value there; the port reproduces the JAX output.
    """
    safe = torch.where(rho < -20.0, torch.zeros_like(rho), rho)
    return torch.where(rho < -20.0, rho, torch.log(F.softplus(safe)))


def _splitmix32(x):
    """splitmix32 finalizer on uint32 values held in an int64 tensor (in
    place) or in a Python int. A tensor product may wrap modulo 2**64, as
    int64 multiplication does on every torch backend; the mask keeps the
    low 32 bits, which is all uint32 arithmetic needs."""
    x ^= x >> 16
    x *= 0x7FEB352D
    x &= _M32
    x ^= x >> 15
    x *= 0x846CA68B
    x &= _M32
    x ^= x >> 16
    return x


def draw_seed(generator: torch.Generator) -> int:
    """One 63-bit seed from a CPU generator: the per-call key of the
    counter-hash draws (the JAX layers split ``rngs.noise()`` instead).
    Drawn on the host, so no device synchronises for it."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator))


def module_generators(module) -> list:
    """The distinct CPU generators that the module and its children hold
    in their ``generator`` attributes, in order of first appearance (one is
    usually shared by a whole model)."""
    found = {}
    for mod in module.modules():
        gen = getattr(mod, "generator", None)
        if isinstance(gen, torch.Generator):
            found.setdefault(id(gen), gen)
    return list(found.values())


def replay_generators(module):
    """A (forward, recompute) pair of contexts, as
    ``torch.utils.checkpoint``'s ``context_fn`` returns them: the forward
    records the state of every generator of the module
    (``module_generators``); the recompute sets the recorded states, runs,
    and then restores the states it found. So the recompute draws what the
    forward drew (the ``draw_seed`` seeds, the device generators seeded
    from them, the Flipout salts, Dropout's masks), and whatever comes
    after it sees the stream it would have seen without the recompute.
    The recompute also runs under the forward's ``DrawWindow``, so a rank
    of a mesh recomputes its own block. ``preserve_rng_state`` covers only
    torch's global generators."""
    gens = module_generators(module)
    recorded = []
    window = []

    @contextlib.contextmanager
    def forward():
        recorded[:] = [gen.get_state() for gen in gens]
        window[:] = [_WINDOW[0]]
        yield

    @contextlib.contextmanager
    def recompute():
        found = [gen.get_state() for gen in gens]
        for gen, state in zip(gens, recorded):
            gen.set_state(state)
        try:
            with draw_window(window[0]):
                yield
        finally:
            for gen, state in zip(gens, found):
                gen.set_state(state)

    return forward(), recompute()


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded with one ``draw_seed`` of the
    layer's CPU generator: the noise of the draws that the JAX package
    makes with ``jax.random.normal`` (the calibration forward, the
    quantized layers' weight builds). ``torch.randn`` on it runs on the
    device, where the counter hash would cost milliseconds per call."""
    device = torch.device(device)
    return torch.Generator(device=device).manual_seed(draw_seed(generator))


def _seed_salt(seed: int, k: int) -> int:
    """32-bit digest of a 64-bit ``seed`` and a stream index ``k``."""
    lo = seed & _M32
    hi = (seed >> 32) & _M32
    return _splitmix32(lo ^ _splitmix32((hi + (k + 1) * _SM32_GOLDEN) & _M32))


def draw_salt(seed: int, s: int, n: int) -> int:
    """Salt of lane ``s`` of a launch that draws ``n`` counters per lane
    under a 64-bit ``seed``: lane 0's salt advanced by ``s * n`` counters,
    so that ``hash(salt_s, i) == hash(salt_0, s*n + i)`` and the S lanes
    read consecutive, disjoint windows of one counter stream. The kernels
    compute the same (csrc/noise.cuh ``btt_draw_salt``); a launch needs
    ``S * n < 2**32`` (``check_counters``)."""
    return (_seed_salt(seed, 0) + s * n * _SM32_GOLDEN) & _M32


def check_counters(num_samples: int, n: int) -> None:
    """Raise unless the ``num_samples`` lanes of ``n`` counters each fit
    in the 32-bit counter stream of one salt."""
    if num_samples * n >= 2**32:
        raise ValueError(f"{num_samples} draws of {n} elements exceed the "
                         "2**32 counters of one salt")


# On the CPU the hash runs in chunks that stay in cache (about 15x faster
# than whole-tensor passes at ResNet-50 size); elsewhere in one pass.
_CPU_CHUNK = 1 << 16


def _hashes(salt: int, start: int, n: int, device):
    """splitmix32(salt + (i+1)*GOLDEN) for i in [start, start + n)."""
    h = torch.arange(start + 1, start + n + 1, dtype=torch.int64,
                     device=device)
    h *= _SM32_GOLDEN
    h += salt
    h &= _M32
    return _splitmix32(h)


def _normals(salt: int, start: int, n: int, device):
    h1 = _hashes(salt, start, n, device)
    h2 = _hashes(salt ^ _SALT2_XOR, start, n, device)
    # 24-bit uniforms: u1 in (0, 1] (no log(0)), u2 in [0, 1)
    u1 = (h1 >> 8).to(torch.float32).mul_(_U24).add_(_U24 * 0.5)
    u2 = (h2 >> 8).to(torch.float32).mul_(_U24)
    r = u1.log_().mul_(-2.0).sqrt_()
    return r.mul_(u2.mul_(_TWO_PI).cos_())


def normal_fused(salt: int, shape, dtype=torch.float32, device=None,
                 start: int = 0):
    """iid N(0,1) from the counter hash: the value at flat position i is
    Box-Muller on two splitmix32 hashes of ``salt + (start+i+1)*GOLDEN``.
    Equals the JAX ``normal_fused`` for the JAX key whose ``_key_salt``
    is ``salt`` (at ``start = 0``)."""
    shape = tuple(shape)
    n = math.prod(shape)
    device = torch.device("cpu") if device is None else torch.device(device)
    chunk = _CPU_CHUNK if device.type == "cpu" else max(n, 1)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for at in range(0, n, chunk):
        m = min(chunk, n - at)
        out[at:at + m] = _normals(salt, start + at, m, device)
    return out.reshape(shape).to(dtype)


class DrawWindow:
    """The block of an MC forward that this rank computes under a mesh
    (``parallel.mc_forward(mesh=)``): draws [lane0, lane0 + local lanes)
    of ``lanes`` and batch rows [row0, row0 + local rows) of ``rows``.
    The sampling sites read it (``current_window``) so that the block's
    noise is the block of the single-process noise: the samplers take
    their lanes' counters, the sign salts their lanes' salts, the signs of
    a batch-leading tensor its rows' counters (``rademacher_fused``),
    Dropout its slice of the whole mask. ``data_group`` is the process
    group over the batch (BatchNorm's statistics)."""

    def __init__(self, lane0, local_lanes, lanes, row0, local_rows, rows,
                 data_group=None):
        self.lane0, self.local_lanes, self.lanes = lane0, local_lanes, lanes
        self.row0, self.local_rows, self.rows = row0, local_rows, rows
        self.data_group = data_group

    @property
    def splits_draws(self):
        return self.local_lanes != self.lanes

    @property
    def splits_rows(self):
        return self.local_rows != self.rows


_WINDOW = [None]


@contextlib.contextmanager
def draw_window(window):
    """Set the current ``DrawWindow`` for the duration (None: none)."""
    saved = _WINDOW[0]
    _WINDOW[0] = window
    try:
        yield window
    finally:
        _WINDOW[0] = saved


def current_window():
    """The ``DrawWindow`` of the forward in progress, or None."""
    return _WINDOW[0]


def window_lanes(num_draws):
    """(first lane, lanes of the whole launch) for a site that draws
    ``num_draws`` lanes: this rank's block under a window that splits the
    draws, else (0, num_draws)."""
    w = _WINDOW[0]
    if w is not None and w.splits_draws and num_draws == w.local_lanes:
        return w.lane0, w.lanes
    return 0, num_draws


def refuse_window(what):
    """Raise if the current window splits draws or rows: ``what`` cannot
    draw a block of the single-process noise."""
    w = _WINDOW[0]
    if w is not None and (w.splits_draws or w.splits_rows):
        raise NotImplementedError(
            f"{what} under mc_forward(mesh=) with the draws or the batch "
            "split over ranks is not supported; use a mesh whose 'mc' and "
            "'data' axes are 1, or mesh=None")


def _row_start(shape):
    """Counter of element 0 of a batch-leading tensor of ``shape`` under a
    window that splits the batch: its rows' place in the whole batch."""
    w = _WINDOW[0]
    if w is None or not w.splits_rows:
        return 0
    if not shape or shape[0] != w.local_rows:
        raise RuntimeError(
            f"signs of shape {tuple(shape)} under a batch split over ranks "
            f"({w.local_rows} of {w.rows} rows): only batch-leading "
            "tensors can take their rows' signs")
    return w.row0 * (math.prod(shape) // shape[0])


_SHARD = [None]


@contextlib.contextmanager
def tp_shard(rank, size, channel_dim):
    """For the forward of a tensor-parallel layer (``parallel/tp.py``):
    its weights and biases are dim-0 shard ``rank`` of ``size`` equal
    shards and its outputs channel shard ``rank`` along ``channel_dim``.
    The samplers then draw the shard's window of each whole tensor's
    counters, and the output signs are the shard's channels of the whole
    output's signs."""
    saved = _SHARD[0]
    _SHARD[0] = (rank, size, channel_dim)
    try:
        yield
    finally:
        _SHARD[0] = saved


def window_kwargs(lane0, stride, offset, n):
    """The sampler's ``window`` keyword (``ops/cuda/sampled_weights.py``)
    for a launch over n elements a lane: ``{}`` for the whole launch, so
    a call without a mesh or a shard is the call it always was."""
    if (lane0, stride, offset) == (0, n, 0):
        return {}
    return {"window": (lane0, stride, offset)}


def shard_window(n):
    """``window_kwargs`` of a one-draw sampler call over n elements: the
    shard's place in the whole tensor inside a ``tp_shard``."""
    shard = _SHARD[0]
    if shard is None:
        return {}
    rank, size, _ = shard
    return window_kwargs(0, size * n, rank * n, n)


def rademacher_fused(salt: int, shape, dtype=torch.float32, device=None,
                     output=False):
    """iid signs in {-1, +1}: bit 31 of splitmix32(salt + (i+1)*GOLDEN),
    bit-identical to the JAX ``rademacher_fused`` for the same salt. Under
    a ``DrawWindow`` that splits the batch, ``shape`` leads with this
    rank's rows, which take the counters they have in the whole batch.
    ``output``: the signs of a layer's output, which inside a
    ``tp_shard`` are the shard's channels of the whole output's signs."""
    shape = tuple(shape)
    shard = _SHARD[0]
    if output and shard is not None:
        rank, size, dim = shard
        whole = list(shape)
        whole[dim] *= size
        return rademacher_fused(salt, whole, dtype, device).narrow(
            dim, rank * shape[dim], shape[dim])
    h = _hashes(salt, _row_start(shape), math.prod(shape), device)
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where((h >> 31).bool(), -one, one).reshape(shape)


def sign_salts(seed: int, s: int = 0):
    """(input-sign salt, output-sign salt) of draw ``s`` under one 64-bit
    ``seed``: the Flipout layers' two sign streams (the JAX ops split
    their key instead)."""
    return _seed_salt(seed, 2 * s), _seed_salt(seed, 2 * s + 1)


def rademacher_lanes(salts, shape, dtype=torch.float32, device=None,
                     axis=1, output=False):
    """Signs over the draw axis: ``shape`` with a lane axis of S =
    ``len(salts)`` inserted at ``axis``; lane s is
    ``rademacher_fused(salts[s], shape)``, the signs a single forward of
    draw s would take for a tensor of ``shape``."""
    shape = tuple(shape)
    out = torch.empty(shape[:axis] + (len(salts),) + shape[axis:],
                      dtype=dtype, device=device)
    for s, salt in enumerate(salts):
        out.select(axis, s).copy_(rademacher_fused(salt, shape, dtype,
                                                   device, output))
    return out


def cast_to(compute_dtype, *tensors):
    """Every given tensor in ``compute_dtype`` (None: as they are; a None
    tensor stays None): the Flipout ops sample and sign-flip in the compute
    dtype, as the JAX ops do."""
    if compute_dtype is None:
        return tensors
    return tuple(None if t is None else t.to(compute_dtype) for t in tensors)


def flipout_combine(x, products, salts, sign_in=None, sign_out=None):
    """The Flipout algebra ``mean + sign_out * pert`` where ``products(x,
    x * sign_in)`` gives ``(mean, pert)``; signs not given come from
    ``salts`` (input-sign salt, output-sign salt)."""
    if sign_in is None:
        sign_in = rademacher_fused(salts[0], x.shape, x.dtype, x.device)
    mean_out, pert = products(x, x * sign_in)
    if sign_out is None:
        sign_out = rademacher_fused(salts[1], mean_out.shape, mean_out.dtype,
                                    mean_out.device, output=True)
    return mean_out + pert * sign_out


def sample_gaussian_delta(generator, mu, rho, eps=None):
    """The Flipout perturbation ``softplus(rho) * eps`` in ``mu``'s dtype:
    from the injected ``eps``, or one draw of the batch sampler's kernel
    on a zero mean, seeded from ``generator``."""
    if eps is not None:
        return sigma_from_rho(rho) * eps
    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_gaussian,
    )
    return sample_gaussian(draw_seed(generator), torch.zeros_like(mu), rho,
                           out_dtype=mu.dtype,
                           **shard_window(mu.numel()))


def sample_gaussian_weight(generator, mu, rho, eps=None):
    """W = mu + softplus(rho) * eps; returns (W, sigma).

    ``eps`` may be injected (golden-value tests). Without it the draw goes
    through ``sample_gaussian``, seeded from ``generator``: the batch
    sampler's kernel with one draw forward and the regenerate-eps kernel
    backward on a CUDA tensor, their plain versions on a CPU one.
    """
    sigma = sigma_from_rho(rho)
    if eps is not None:
        return mu + sigma * eps, sigma
    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_gaussian,
    )
    return sample_gaussian(draw_seed(generator), mu, rho,
                           out_dtype=mu.dtype,
                           **shard_window(mu.numel())), sigma
