"""Shared Bayesian LSTM, both estimators (counterpart of
``bayesian_torch_tpu/layers/rnn_base.py``).

The cell is two Bayesian linear blocks, ``ih`` (in -> 4H) and ``hh`` (H ->
4H), with the gates in the order i, f, g, o. The return convention is the
reference's, including its quirk of returning the whole hidden sequence as
the state: ``(hidden_seq, (hidden_seq, c_seq), kl)``, with ``kl = T *
(kl_ih + kl_hh)`` (the KL depends on the parameters only).

Three branches, as in the JAX layer:

- per-step draws (``resample_per_step=True``, the default): every step t
  has weights of its own. JAX folds t into its key; here the T steps are T
  lanes of the batch sampler (K-A), so a forward makes one launch per
  tensor (ih W, ih b, hh W, hh b), not one per tensor and step, and the
  backward regenerates the noise (K-C dsigma). The input half of the gates
  is known for every step before the recurrence and is one batched product;
  the recurrent half is a loop over t. Flipout draws the perturbations
  ``sigma * eps`` on a zero mean the same way and takes its signs from one
  counter-hash call per block and side over the whole sequence;
- one draw per sequence (``resample_per_step=False``): one draw of each
  tensor (K-A's rho mode), then the loop with fixed weights. As in the JAX
  layer this branch samples whole weights for both estimators, in the
  parameters' dtype (the compute dtype applies to the per-step branch);
- the quantized cell, taken once ``bnn_to_qbnn`` has quantized ``ih`` and
  ``hh``: one f32 weight per sequence and draw, ``dequantize(q_mu) +
  dequantize(q_sigma) * eps`` (eps from a device generator seeded by the
  layer's, one (S, ...) ``torch.randn`` for the S draws), the biases from
  each block's ``_sample_bias``, no KL.

The draw axis (``_mc_draws`` = S, set by ``mc_forward``'s vmap emission):
the input is (B, T, in), shared by the draws, or (B, T, S*in) with draw s
in block s; the state is (B, S*H) and the outputs (B, T, S*H). The S*T
weight sets of each tensor come from one K-A launch (lane s*T + t is draw
s, step t); the quantized cell draws its S weights of each block at once.

Under ``mc_forward(mesh=)`` a rank computes its block of the single
process's draws and rows: its draws' T lanes of each K-A launch (a counter
window, ``ops.sampling.step_lanes``; K-C differentiates the same window),
its block of each sign tensor (``rademacher_block``), its draws of the
quantized cell's normals, and its rows of a whole-batch initial state.
Under ``shard_params_tp`` the LSTM gathers its blocks' shards at each
forward and runs the replicated cell (``parallel/tp.py``).

Injected noise (keyword-only, each a pair ``(ih, hh)``): ``eps_w`` /
``eps_b`` with a leading T axis per step (none in the other two branches),
``sign_in`` / ``sign_out`` shaped (T, B, features) for Flipout; under the
draw axis each carries a leading S axis first.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
    default_generator,
)
from bayesian_torch_tpu_torch.ops.int8 import dequantize
from bayesian_torch_tpu_torch.ops.sampling import (cast_to,
                                                   current_window,
                                                   device_generator,
                                                   draw_seed,
                                                   rademacher_block,
                                                   sigma_from_rho,
                                                   sign_salts, step_lanes,
                                                   window_block,
                                                   window_lanes)


def _pair(hook):
    return (None, None) if hook is None else hook


class _BaseLSTMLayer(BaseVariationalLayer):
    estimator = "reparameterization"  # or "flipout"
    takes_draw_axis = True
    # the per-step weights are drawn for the sequence the forward is given,
    # so mc_forward's presample leaves them to the forward
    draws_in_forward = True
    # shard_params_tp keeps these blocks' row shards and gathers them at
    # each forward (parallel/tp.py)
    tp_blocks = ("ih", "hh")

    def __init__(self,
                 in_features: int,
                 out_features: int,
                 prior_mean: float = 0,
                 prior_variance: float = 1,
                 posterior_mu_init: float = 0,
                 posterior_rho_init: float = -3.0,
                 bias: bool = True,
                 *,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 compute_dtype=None,
                 resample_per_step: bool = True):
        super().__init__()
        from bayesian_torch_tpu_torch.layers.flipout_layers.linear_flipout \
            import LinearFlipout
        from bayesian_torch_tpu_torch.layers.variational_layers \
            .linear_variational import LinearReparameterization

        self.generator = generator if generator is not None \
            else default_generator()
        self.in_features = in_features
        self.out_features = out_features
        self.prior_mean = prior_mean
        self.prior_variance = prior_variance
        self.posterior_mu_init = posterior_mu_init
        self.posterior_rho_init = posterior_rho_init
        self.bias = bias
        self.compute_dtype = compute_dtype
        self.resample_per_step = resample_per_step

        linear_cls = (LinearFlipout if self.estimator == "flipout"
                      else LinearReparameterization)
        common = dict(prior_mean=prior_mean, prior_variance=prior_variance,
                      posterior_mu_init=posterior_mu_init,
                      posterior_rho_init=posterior_rho_init, bias=bias,
                      generator=self.generator, device=device,
                      compute_dtype=compute_dtype)
        self.ih = linear_cls(in_features, out_features * 4, **common)
        self.hh = linear_cls(out_features, out_features * 4, **common)

    def kl_loss(self):
        """kl(ih) + kl(hh)."""
        return self.ih.kl_loss() + self.hh.kl_loss()

    def forward(self, X, hidden_states=None, return_kl: bool = True, *,
                eps_w=None, eps_b=None, sign_in=None, sign_out=None):
        if self.dnn_to_bnn_flag:
            return_kl = False
        draws = getattr(self, "_mc_draws", None) or 1
        x, h0, c0 = self._lanes_in(X, hidden_states, draws)
        if hasattr(self.ih, "quantized_mu_weight"):
            h_seq, c_seq = self._forward_quantized(x, h0, c0, draws, eps_w,
                                                   eps_b)
            kl = 0.0
        else:
            h_seq, c_seq = self._forward_float(x, h0, c0, draws, eps_w,
                                               eps_b, sign_in, sign_out)
            kl = (X.shape[1] * self.kl_loss()) if self.compute_kl else 0.0
        hidden_seq, c_ts = self._lanes_out(h_seq), self._lanes_out(c_seq)
        if return_kl:
            return hidden_seq, (hidden_seq, c_ts), kl
        return hidden_seq, (hidden_seq, c_ts)

    # ---- layout: (B, T, [S*]F) <-> (S, T, B, F) -------------------------

    def _lanes_in(self, X, hidden_states, draws):
        """x (S or 1, T, B, in) and the initial state (S, B, H)."""
        B, T, feat = X.shape
        H = self.out_features
        if feat == self.in_features:
            x = X.transpose(0, 1)[None]
        elif feat == draws * self.in_features:
            x = X.reshape(B, T, draws, self.in_features).permute(2, 1, 0, 3)
        else:
            raise ValueError(
                f"{type(self).__name__} over {draws} draws: input has {feat} "
                f"features, want {self.in_features} (shared) or "
                f"{draws * self.in_features} (one block per draw)")
        if hidden_states is None:
            # the state is carried in the input's dtype, as in JAX; the
            # products run in the compute dtype
            zeros = torch.zeros((draws, B, H), dtype=X.dtype,
                                device=X.device)
            return x, zeros, zeros
        h0, c0 = (self._state_block(s, B, draws) for s in hidden_states)
        return x, h0, c0

    def _state_block(self, state, B, draws):
        """A caller's (rows, [S*]H) state as (S, B, H); under a mesh that
        splits the batch a whole-batch state gives this rank's rows, as
        the input is split."""
        w = current_window()
        if w is not None and w.splits_rows and state.shape[0] == w.rows \
                and B != w.rows:
            state = state[w.row0:w.row0 + B]
        H = self.out_features
        return state.reshape(B, -1, H).transpose(0, 1).expand(draws, B, H)

    def _lanes_out(self, seq):
        """(S, T, B, H) -> (B, T, H), or (B, T, S*H) under the draw axis."""
        S, T, B, H = seq.shape
        if getattr(self, "_mc_draws", None):
            return seq.permute(2, 1, 0, 3).reshape(B, T, S * H)
        return seq[0].transpose(0, 1)

    # ---- the recurrence -------------------------------------------------

    def _recur(self, gx, h, c, recurrent):
        """The loop over t: gates = gx[:, t] + recurrent(h, t), split i, f,
        g, o; returns the (S, T, B, H) sequences of h and c."""
        hs, cs = [], []
        for t in range(gx.shape[1]):
            gates = gx[:, t] + recurrent(h, t)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
            cs.append(c)
        return torch.stack(hs, 1), torch.stack(cs, 1)

    def _draw(self, lin, lanes, dtype, eps_w, eps_b, zero_mean, draws=1):
        """``lanes`` draws of block ``lin``'s weight (lanes, 4H, K) and bias
        (lanes, 4H) or None, in ``dtype``: ``mu + sigma * eps``, or with
        ``zero_mean`` the Flipout perturbation ``sigma * eps``; ``lanes`` is
        ``draws`` draws of ``lanes // draws`` steps each. Without injected
        noise each tensor is one K-A launch under a seed of its own (a
        single lane: K-A's rho mode); under a mesh that splits the draws,
        this rank's lanes of the single-process launch (``step_lanes``)."""
        from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
            sample_gaussian,
            sample_gaussian_batch,
        )
        out = []
        for mu, rho, eps in ((lin.mu_weight, lin.rho_weight, eps_w),
                             (lin.mu_bias, lin.rho_bias, eps_b)):
            if mu is None:
                out.append(None)
                continue
            if eps is not None:
                noise = sigma_from_rho(rho) * eps.reshape(
                    (lanes,) + tuple(mu.shape)).to(mu.dtype)
                out.append((noise if zero_mean else mu + noise).to(dtype))
                continue
            mean = torch.zeros_like(mu) if zero_mean else mu
            seed = draw_seed(self.generator)
            window = step_lanes(draws, lanes // draws, mu.numel())
            if lanes == 1 and not window:
                out.append(sample_gaussian(seed, mean, rho,
                                           out_dtype=dtype)[None])
            else:
                out.append(sample_gaussian_batch(seed, mean, rho, lanes,
                                                 dtype, **window))
        return out

    def _forward_float(self, x, h, c, draws, eps_w, eps_b, sign_in,
                       sign_out):
        T, B = x.shape[1], x.shape[2]
        per_step = self.resample_per_step
        # as in JAX, one draw per sequence samples and multiplies in the
        # parameters' dtype whatever the compute dtype
        dtype = (self.compute_dtype if per_step else None) \
            or self.ih.mu_weight.dtype
        x = x.to(dtype)
        flip = per_step and self.estimator == "flipout"
        steps = T if per_step else 1
        (ew_ih, ew_hh), (eb_ih, eb_hh) = _pair(eps_w), _pair(eps_b)
        w_ih, b_ih = self._draw(self.ih, draws * steps, dtype, ew_ih, eb_ih,
                                flip, draws)
        w_hh, b_hh = self._draw(self.hh, draws * steps, dtype, ew_hh, eb_hh,
                                flip, draws)

        def lanes(w, rows=False):
            """(S*steps, ...) -> (S, steps, ...); ``rows``: a bias with a
            broadcast row axis (S, steps, 1, 4H)."""
            if w is None:
                return None
            w = w.reshape((draws, steps) + tuple(w.shape[1:]))
            return w[:, :, None] if rows else w

        w_ih, w_hh = lanes(w_ih).transpose(-1, -2), lanes(w_hh)
        b_ih, b_hh = lanes(b_ih, rows=True), lanes(b_hh, rows=True)
        if not flip:
            # both biases ride the input half, known for every step
            gx = torch.matmul(x, w_ih)
            for b in (b_ih, b_hh):
                if b is not None:
                    gx = gx + b
            return self._recur(gx, h, c, lambda h, t: torch.matmul(
                h.to(dtype), w_hh[:, t if per_step else 0].transpose(-1, -2)))

        si_ih, si_hh, so_ih, so_hh = self._signs(
            draws, T, B, dtype, x.device, sign_in, sign_out)
        mu_ih, mu_b_ih, mu_hh, mu_b_hh = cast_to(
            dtype, self.ih.mu_weight, self.ih.mu_bias, self.hh.mu_weight,
            self.hh.mu_bias)
        pert = torch.matmul(x * si_ih, w_ih)
        if b_ih is not None:
            pert = pert + b_ih
        gx = F.linear(x, mu_ih, mu_b_ih) + pert * so_ih

        def recurrent(h, t):
            h = h.to(dtype)
            pert = torch.matmul(h * si_hh[:, t], w_hh[:, t].transpose(-1, -2))
            if b_hh is not None:
                pert = pert + b_hh[:, t]
            return F.linear(h, mu_hh, mu_b_hh) + pert * so_hh[:, t]

        return self._recur(gx, h, c, recurrent)

    def _signs(self, draws, T, B, dtype, device, sign_in, sign_out):
        """The Flipout signs (S, T, B, features) of the ih and hh inputs and
        outputs: injected, or one counter-hash call each under salts of one
        seed; under a mesh that splits the draws or the batch, this rank's
        block of the single-process signs (``window_block``)."""
        H, n_in = self.out_features, self.in_features
        (si_ih, si_hh), (so_ih, so_hh) = _pair(sign_in), _pair(sign_out)
        salts = None
        if any(s is None for s in (si_ih, si_hh, so_ih, so_hh)):
            seed = draw_seed(self.generator)
            salts = (sign_salts(seed, 0), sign_salts(seed, 1))
        out = []
        for given, block, side, feat in ((si_ih, 0, 0, n_in),
                                         (si_hh, 1, 0, H),
                                         (so_ih, 0, 1, 4 * H),
                                         (so_hh, 1, 1, 4 * H)):
            shape = (draws, T, B, feat)
            if given is not None:
                out.append(given.reshape(shape).to(dtype))
                continue
            whole, start = window_block(shape, lane_dim=0, row_dim=2)
            out.append(rademacher_block(salts[block][side], whole, start,
                                        shape, dtype, device))
        return out

    # ---- the quantized cell ---------------------------------------------

    @torch.no_grad()
    def _forward_quantized(self, x, h, c, draws, eps_w, eps_b):
        """One f32 weight per sequence and draw from the int8 posteriors
        ((S, 4H, K) for S draws), then the loop (JAX :117-161); ``eps_w`` /
        ``eps_b`` pairs may be injected."""
        (ew_ih, ew_hh), (eb_ih, eb_hh) = _pair(eps_w), _pair(eps_b)
        gen = None
        if ew_ih is None or ew_hh is None:
            gen = device_generator(self.generator,
                                   self.ih.quantized_mu_weight.device)

        # under a mesh that splits the draws: this rank's of them all
        lane0, lanes = window_lanes(draws)

        def normals(shape, generator, device):
            return torch.randn((lanes,) + shape, generator=generator,
                               device=device)[lane0:lane0 + draws]

        def weight(lin, eps):
            shape = (draws,) + tuple(lin.quantized_mu_weight.shape)
            if eps is None:
                eps = normals(shape[1:], gen, lin.quantized_mu_weight.device)
            return (dequantize(lin.quantized_mu_weight, lin.mu_weight_scale)
                    + dequantize(lin.quantized_sigma_weight,
                                 lin.sigma_weight_scale) * eps.reshape(shape))

        def bias(lin, eps):
            if lin.quantized_mu_bias is None:
                return None
            shape = (draws,) + tuple(lin.quantized_mu_bias.shape)
            if eps is None and lin.quantized_sigma_bias is not None:
                eps = normals(shape[1:], lin._noise(),
                              lin.quantized_mu_bias.device)
            b = lin._sample_bias(None if eps is None else eps.reshape(shape))
            return b.reshape(-1, 1, 1, b.shape[-1])  # (S or 1, 1, 1, 4H)

        w_ih, w_hh = weight(self.ih, ew_ih), weight(self.hh, ew_hh)
        b_ih, b_hh = bias(self.ih, eb_ih), bias(self.hh, eb_hh)
        gx = torch.matmul(x.float(), w_ih.transpose(-1, -2)[:, None])
        if b_ih is not None:
            gx = gx + (b_ih + (b_hh if b_hh is not None else 0.0))
        w_hh = w_hh.transpose(-1, -2)
        return self._recur(gx, h.float(), c.float(),
                           lambda h, t: torch.matmul(h, w_hh))

    def __repr__(self):
        return f"{type(self).__name__}()"

