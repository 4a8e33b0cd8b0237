"""Shared implementation of the INT8 quantized Bayesian layers, both
estimators (counterpart of ``bayesian_torch_tpu/layers/quantized_base.py``).

- ``quantize()`` converts the float posterior: symmetric per-tensor int8
  mu and sigma = softplus(rho), scale 2*clamp(max|x|, 0, 100)/255; the bias
  stays f32. With ``bn_*`` attributes attached (``bnn_to_qbnn``'s conv+BN
  folding) gamma/sqrt(var + eps) is folded into mu and sigma first (on
  the output-channel axis: dim 0, or dim 1 per group of a transposed
  kernel (I, O/g, *k)) and the bias rebuilt. The float parameters are
  then deleted, so the ``state_dict`` holds only the quantized persistent
  buffers, under the JAX names: ``quantized_mu_weight``,
  ``quantized_sigma_weight``, ``mu_weight_scale``, ``sigma_weight_scale``,
  ``quantized_mu_bias``, ``quantized_sigma_bias``. The scales are also
  kept as Python floats (``_mu_scale_f``, ``_sigma_scale_f``), so every
  requantization multiplier is a host constant; loading a state dict
  rebuilds them.
- Reparameterization: each forward draws one quantized weight: eps
  (``torch.randn`` on the weights' device, seeded from the layer's
  generator), quantized, then a quantized mul and add build the int8
  weight. The calibrated path uses the ``quant_dict`` scales; without
  one, the reference's defaults (eps at 6/255, activations at scale 0.2,
  zero point 128).
- Flipout: each forward draws one quantized perturbation ``delta = sigma
  * eps`` (a quantized mul) and runs two int8 products, the mean (mu, the
  mean bias) and the perturbation (delta, ``sigma_b * eps_b``) on the
  input times its Rademacher signs, whose output is multiplied by the
  output signs and added to the mean in uint8. The signs come from the
  counter hash (``ops.sampling.rademacher_fused``) under salts from the
  layer's generator, as the float Flipout layers draw theirs; the
  calibrated path reads the 10-slot ``quant_dict`` (eps, delta, x,
  outputs, sign_in, sign_out, x_tmp, pert_tmp, perturbed, out).
  ``sign_in`` / ``sign_out`` may be injected.
- The int8 GEMM or conv runs through ``ops/int8.py`` (K-F on the card),
  and the output is requantized; ``q_output`` emits a ``QTensor``,
  otherwise the dequantized f32 tensor.
- ``legacy_ao`` (the ``ao.nn.quantized.modules`` classes): ``quantize()``
  also takes the bias through an int8 round trip, the default scale is
  0.1, and there is no ``quant_dict`` path.
- ``forward`` returns ``(out, 0)``: quantized layers carry no KL.

Frozen draws (``quantization.serving``) are buffers ``_frozen_w``,
``_frozen_wscale`` and ``_frozen_bias``: the weight of a
reparameterization layer, the perturbation of a Flipout layer (whose signs
stay per call). ``mc_forward``'s presample attaches the record that
``presample(S)`` returns: the layer's S weights (Flipout: perturbations,
``_presampled_qw``) with their scale and the ``normal_scale`` they were
built for, which a call at another ``normal_scale`` refuses, and a Flipout
layer's S sign salts (``_presampled_signs``).

Under the draw axis (``_mc_draws`` = S, ``mc_forward``'s vmap emission)
the input is (B, S*C, ...) (a linear layer's (..., S*K)) with draw s in
block s, or shared and then tiled to S blocks, a float tensor or a
``QTensor``. The S int8 weights are the presample record, or one build
over the draw axis as ``presample`` makes it; a frozen draw serves every
block; each draw has its own bias and the scales stay per layer. A conv
runs as ``ops.int8.qconv`` grouped S*groups ways (one K-F GEMM a group,
the loop's GEMMs), a linear layer as one K-F GEMM a block; Flipout's mean
product takes ``mu`` in every block and its signs come per block from
``rademacher_lanes``. So each block equals the loop's draw bit for bit on
the same record and signs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
    default_generator,
    get_kernel_size,
)
from bayesian_torch_tpu_torch.ops import int8 as q
from bayesian_torch_tpu_torch.ops.qtensor import QTensor
from bayesian_torch_tpu_torch.ops.sampling import (device_generator,
                                                   draw_seed,
                                                   rademacher_fused,
                                                   rademacher_lanes,
                                                   sigma_from_rho,
                                                   sign_salts,
                                                   window_lanes)

FROZEN = ("_frozen_w", "_frozen_wscale", "_frozen_bias")
# eps's scale on the uncalibrated path: the forward's default, and the
# scale the presample builds for
NORMAL_SCALE = 6 / 255


def _refresh_after_load(module, incompatible_keys):
    module._refresh_scales()


def _per_draw(t, num_draws):
    """``t`` repeated on a new leading draw axis (a view); None stays."""
    return None if t is None else t.expand((num_draws,) + tuple(t.shape))


def _first(v):
    """One draw's value of a record entry: the whole record under the
    draw axis holds every draw's (equal) scale."""
    return v[0] if isinstance(v, (list, tuple)) else v


def _int8_round_trip(x):
    """x through symmetric int8 and back (scale 0.1 where x is all zero)."""
    scale = q.symmetric_scale(x)
    return q.quantize_int8(x, scale).float() * scale


class _QuantizedLayerBase(BaseVariationalLayer):
    """``quantize()`` and the int8 forwards; subclasses set ``estimator``,
    ``is_conv``, ``nd``, ``transposed`` and ``legacy_ao``."""

    estimator = "reparameterization"
    is_conv = False
    transposed = False
    legacy_ao = False
    takes_draw_axis = True

    def _init_common(self, generator):
        super().__init__()
        self.generator = generator if generator is not None \
            else default_generator()
        self.quant_dict = None
        self.bn_eps = 1e-5  # bn_* attributes attached by batch_norm_folding
        # emit a QTensor (uint8 + static scale, zp) instead of the
        # dequantized f32 tensor (set by bnn_to_qbnn(quantize_activations))
        self.q_output = False
        self._frozen_wscale_f = None
        self.register_load_state_dict_post_hook(_refresh_after_load)

    # ---- quantize() ---------------------------------------------------

    def _kernel_attr(self):
        return "mu_kernel" if self.is_conv else "mu_weight"

    def _rho_attr(self):
        return "rho_kernel" if self.is_conv else "rho_weight"

    def _bn_coef(self):
        # the correctly rounded f32 square root, as XLA computes it (torch's
        # vectorised CPU sqrt is not always correctly rounded; the f64 root
        # rounded once to f32 is)
        root = torch.sqrt((self.bn_running_var + self.bn_eps).double())
        return self.bn_weight / root.float()

    def _fold(self, w, coef):
        """w * coef over the kernel's output channels."""
        if not self.transposed:
            return w * coef.reshape((-1,) + (1,) * (w.dim() - 1))
        groups = self.groups
        wg = w.reshape((groups, w.shape[0] // groups) + tuple(w.shape[1:]))
        cg = coef.reshape((groups, 1, -1) + (1,) * (w.dim() - 2))
        return (wg * cg).reshape(w.shape)

    def _refresh_scales(self):
        """Rebuild the host copies of the scales from the buffers."""
        if getattr(self, "mu_weight_scale", None) is None:
            return  # not quantized yet
        self._mu_scale_f = float(self.mu_weight_scale)
        self._sigma_scale_f = float(self.sigma_weight_scale)
        fw = getattr(self, "_frozen_wscale", None)
        self._frozen_wscale_f = None if fw is None else np.float32(fw.item())

    @torch.no_grad()
    def quantize(self):
        """Convert the float posterior to int8 (with BN folding when bn_*
        attributes are attached) and delete it."""
        mu = getattr(self, self._kernel_attr()).detach()
        sigma = sigma_from_rho(getattr(self, self._rho_attr()).detach())
        folding = getattr(self, "bn_weight", None) is not None
        if folding:
            coef = self._bn_coef()
            mu = self._fold(mu, coef)
            sigma = self._fold(sigma, coef)

        mu_scale = q.symmetric_scale(mu)
        sigma_scale = q.symmetric_scale(sigma)
        self.register_buffer("quantized_mu_weight",
                             q.quantize_int8(mu, mu_scale))
        self.register_buffer("quantized_sigma_weight",
                             q.quantize_int8(sigma, sigma_scale))
        self.register_buffer("mu_weight_scale", mu_scale)
        self.register_buffer("sigma_weight_scale", sigma_scale)

        mu_b = sigma_b = None
        if getattr(self, "mu_bias", None) is not None:
            mu_b = self.mu_bias.detach()
            sigma_b = sigma_from_rho(self.rho_bias.detach())
            if folding:
                coef = self._bn_coef()
                mu_b = (mu_b - self.bn_running_mean) * coef + self.bn_bias
                sigma_b = sigma_b * coef
            if self.legacy_ao:
                mu_b = _int8_round_trip(mu_b)
                sigma_b = _int8_round_trip(sigma_b)
        elif folding:
            # the conv had no bias; folding makes a mean-only one
            mu_b = -self.bn_running_mean * self._bn_coef() + self.bn_bias
            self.bias = True
        self.register_buffer("quantized_mu_bias", mu_b)
        self.register_buffer("quantized_sigma_bias", sigma_b)
        self._refresh_scales()

        for attr in (self._kernel_attr(), self._rho_attr(), "mu_bias",
                     "rho_bias", "bn_weight", "bn_bias", "bn_running_mean",
                     "bn_running_var"):
            if hasattr(self, attr):
                delattr(self, attr)

    def kl_loss(self):
        return 0.0

    # ---- the int8 forward ------------------------------------------------

    def _calibrated(self):
        """The ``quant_dict`` path (the legacy classes have none)."""
        return self.quant_dict is not None and not self.legacy_ao

    def _qd(self, i):
        d = self.quant_dict[i]
        return float(d["scale"]), float(d["zero_point"])

    def _apply_int8(self, x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale,
                    out_zp, num_draws=None):
        """The int8 product; with ``num_draws`` S, of S draws: ``w_q`` (S,
        ...) and ``bias`` (S, O) over the S blocks of ``x_q``."""
        if self.is_conv:
            groups = self.groups
            if num_draws:
                # the draws' kernels side by side on the leading axis, one
                # group (of each of the layer's groups) per draw
                w_q = w_q.reshape((-1,) + tuple(w_q.shape[2:]))
                bias = None if bias is None else bias.reshape(-1)
                groups *= num_draws
            return q.qconv(x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale,
                           out_zp, stride=self.stride, padding=self.padding,
                           dilation=self.dilation, groups=groups,
                           transposed=self.transposed,
                           output_padding=self.output_padding)
        if not num_draws:
            return q.qlinear(x_q, x_scale, x_zp, w_q, w_scale, bias,
                             out_scale, out_zp)
        k = w_q.shape[-1]
        return torch.cat([q.qlinear(
            x_q[..., s * k:(s + 1) * k], x_scale, x_zp, w_q[s], w_scale,
            None if bias is None else bias[s], out_scale, out_zp)
            for s in range(num_draws)], dim=-1)

    def _draw_dim(self, ndim):
        """The axis that holds the draw blocks: channels, or a linear
        layer's features."""
        return 1 if self.is_conv else ndim - 1

    def _tile_draws(self, x_q, num_draws):
        """A shared uint8 input (B, C, ...) tiled to S draw blocks; a
        blocked one as it is."""
        dim = self._draw_dim(x_q.dim())
        width = self.in_channels if self.is_conv else self.in_features
        if x_q.shape[dim] == width:
            return torch.cat([x_q] * num_draws, dim=dim)
        if x_q.shape[dim] != num_draws * width:
            raise ValueError(
                f"{type(self).__name__} over {num_draws} draws: input has "
                f"{x_q.shape[dim]} features on axis {dim}, want {width} "
                f"(shared) or {num_draws * width} (one block per draw)")
        return x_q

    def _quantize_input(self, x, scale, zp):
        """f32 -> uint8, or a uint8 -> uint8 requantize of a QTensor."""
        if isinstance(x, QTensor):
            return x.requantize(scale, zp).q
        return q.quantize_uint8(x, scale, zp)

    def _emit(self, out_q, scale, zp):
        if self.q_output:
            return QTensor(out_q, scale, zp)
        return q.dequantize(out_q, scale, zp)

    def _noise(self):
        return device_generator(self.generator,
                                self.quantized_mu_weight.device)

    def _sample_bias(self, eps_b=None, gen=None):
        """f32 sampled bias; the mean alone when folding made it."""
        if self.quantized_mu_bias is None:
            return None
        if self.quantized_sigma_bias is None:
            return self.quantized_mu_bias
        if eps_b is None:
            eps_b = torch.randn(self.quantized_mu_bias.shape,
                                generator=gen if gen is not None
                                else self._noise(),
                                device=self.quantized_mu_bias.device)
        return self.quantized_mu_bias + self.quantized_sigma_bias * eps_b

    @torch.no_grad()
    def _sampled_qweight_reparam(self, normal_scale, eps=None, eps_b=None):
        """One quantized weight draw: (w_q int8, w_scale, bias f32 or
        None). ``eps`` / ``eps_b`` may be injected, with a leading (S, ...)
        draw axis too: the arithmetic is elementwise with scalar scales,
        so the presample builds all S draws in one pass."""
        gen = None
        if eps is None:
            gen = self._noise()
            eps = torch.randn(self.quantized_mu_weight.shape, generator=gen,
                              device=self.quantized_mu_weight.device)
        s_sigma, s_mu = self._sigma_scale_f, self._mu_scale_f
        if self._calibrated():
            s0, _ = self._qd(0)    # eps
            s1, z1 = self._qd(1)   # sigma * eps
            s2, z2 = self._qd(2)   # weight
            eps_q = q.quantize_int8(eps, s0)
            w_q = q.qmul(self.quantized_sigma_weight, s_sigma, eps_q, s0, s1,
                         z1)
            w_q = q.qadd(w_q, s1, self.quantized_mu_weight, s_mu, s2, z2)
            return w_q, s2, self._sample_bias(eps_b, gen)
        # uncalibrated default path (reference quantize_linear_variational
        # .py:202-219)
        eps_q = q.quantize_int8(eps, normal_scale)
        new_scale = s_sigma * normal_scale
        w_q = q.qmul(self.quantized_sigma_weight, s_sigma, eps_q,
                     normal_scale, new_scale, 0)
        add_scale = max(new_scale, s_mu)
        w_q = q.qadd(w_q, new_scale, self.quantized_mu_weight, s_mu,
                     add_scale, 0)
        return w_q, add_scale, self._sample_bias(eps_b, gen)

    def _frozen(self):
        """The frozen draw (w_q, w_scale, bias), or None."""
        if getattr(self, "_frozen_w", None) is None:
            return None
        return (self._frozen_w, self._frozen_wscale_f,
                getattr(self, "_frozen_bias", None))

    def _build(self, normal_scale, num_draws=None):
        """A new weight draw (Flipout: perturbation) as (w_q, scale, bias);
        with ``num_draws`` S, S of them in one pass over the draw axis: (S,
        ...) eps and bias eps on the weights' device, then the
        elementwise build, the bias (S, O) or None."""
        build = self._sampled_qdelta_flipout if self.estimator == "flipout" \
            else self._sampled_qweight_reparam
        if not num_draws:
            return build(normal_scale)
        gen = self._noise()
        # under a mesh that splits the draws: this rank's lanes of them all
        lane0, lanes = window_lanes(num_draws)
        eps = torch.randn((lanes,) + tuple(self.quantized_mu_weight.shape),
                          generator=gen,
                          device=self.quantized_mu_weight.device)
        eps = eps[lane0:lane0 + num_draws]
        eps_b = None
        if self.quantized_sigma_bias is not None:
            eps_b = torch.randn(
                (lanes,) + tuple(self.quantized_sigma_bias.shape),
                generator=gen, device=self.quantized_sigma_bias.device)
            eps_b = eps_b[lane0:lane0 + num_draws]
        w_q, w_scale, bias = build(normal_scale, eps=eps, eps_b=eps_b)
        if bias is not None and eps_b is None:
            bias = _per_draw(bias, num_draws)  # a folded mean-only bias
        return w_q, w_scale, bias

    def _this_draw(self, normal_scale, num_draws=None):
        """This call's (w_q, scale, bias), from the frozen draw, the
        presample record or a new build (``_build``); with ``num_draws``
        every tensor has the leading draw axis."""
        draw = self._frozen()
        if draw is not None:
            if num_draws:
                w_q, w_scale, bias = draw
                return (_per_draw(w_q, num_draws), w_scale,
                        _per_draw(bias, num_draws))
            return draw
        pres = getattr(self, "_presampled_qw", None)
        if pres is None:
            return self._build(normal_scale, num_draws)
        # the calibrated path reads no normal_scale, the default path
        # only the recorded one
        recorded = _first(self._presampled_qnscale)
        if not self._calibrated() and normal_scale != recorded:
            raise ValueError(
                f"normal_scale {normal_scale} differs from the {recorded} "
                "the presampled weights were built for")
        bias = getattr(self, "_presampled_qbias", None)
        if bias is None and self.estimator != "flipout":
            # a folded mean-only bias is the same in every draw
            bias = self._sample_bias()
            if num_draws:
                bias = _per_draw(bias, num_draws)
        return pres, _first(self._presampled_qscale), bias

    @torch.no_grad()
    def presample(self, num_mc):
        """This layer's record for ``mc_forward``'s presample: {attr: a
        sequence over the ``num_mc`` draws}. Without a frozen draw the
        layer builds its int8 weights (Flipout: perturbations) for all
        draws in one pass (``_build``), beside their scale and the
        ``normal_scale`` they were built for; a Flipout layer also takes
        its draws' sign salts under one seed of its generator, so the loop
        and the draw axis flip the same signs in draw s."""
        record = {}
        if self._frozen() is None:
            w_q, w_scale, bias = self._build(NORMAL_SCALE, num_mc)
            record = {"_presampled_qw": w_q,
                      "_presampled_qscale": [w_scale] * num_mc,
                      "_presampled_qnscale": [NORMAL_SCALE] * num_mc}
            if self.quantized_sigma_bias is not None:
                # else the bias is the same in every draw
                record["_presampled_qbias"] = bias
        if self.estimator == "flipout":
            seed = draw_seed(self.generator)
            record["_presampled_signs"] = torch.tensor(
                [sign_salts(seed, s) for s in range(num_mc)],
                dtype=torch.int64)
        return record

    def _forward_reparam(self, input, normal_scale, default_scale,
                         default_zero_point):
        num_draws = getattr(self, "_mc_draws", None)
        w_q, w_scale, bias = self._this_draw(normal_scale, num_draws)
        if self._calibrated():
            s3, z3 = self._qd(3)   # input
            s4, z4 = self._qd(4)   # output
        else:
            s3 = s4 = default_scale
            z3 = z4 = default_zero_point
        x_q = self._quantize_input(input, s3, z3)
        if num_draws:
            x_q = self._tile_draws(x_q, num_draws)
        out_q = self._apply_int8(x_q, s3, z3, w_q, w_scale, bias, s4, z4,
                                 num_draws)
        return self._emit(out_q, s4, z4)

    @torch.no_grad()
    def _sampled_qdelta_flipout(self, normal_scale, eps=None, eps_b=None):
        """One quantized perturbation draw: (delta_q int8, delta_scale,
        pert_bias f32 or None). ``eps`` / ``eps_b`` may be injected."""
        gen = None
        if eps is None:
            gen = self._noise()
            eps = torch.randn(self.quantized_mu_weight.shape, generator=gen,
                              device=self.quantized_mu_weight.device)
        s_sigma = self._sigma_scale_f
        pert_bias = None
        if self.quantized_sigma_bias is not None:
            if eps_b is None:
                eps_b = torch.randn(self.quantized_sigma_bias.shape,
                                    generator=gen if gen is not None
                                    else self._noise(),
                                    device=self.quantized_sigma_bias.device)
            pert_bias = self.quantized_sigma_bias * eps_b
        if self._calibrated():
            s0, _ = self._qd(0)    # eps
            s1, z1 = self._qd(1)   # delta
            eps_q = q.quantize_int8(eps, s0)
            return (q.qmul(self.quantized_sigma_weight, s_sigma, eps_q, s0,
                           s1, z1), s1, pert_bias)
        # uncalibrated default path (reference quantized_linear_flipout
        # .py:229-256)
        eps_q = q.quantize_int8(eps, normal_scale)
        new_scale = s_sigma * normal_scale
        return (q.qmul(self.quantized_sigma_weight, s_sigma, eps_q,
                       normal_scale, new_scale, 0), new_scale, pert_bias)

    def _signs(self, x_shape, out_shape, device, sign_in, sign_out,
               num_draws=None):
        """The f32 Rademacher signs of the input and of the output: the
        injected ones, else the counter hash under this call's salts; with
        ``num_draws``, block s under draw s's salts (the signs the loop's
        draw s takes)."""
        if sign_in is None or sign_out is None:
            salts = self._sign_salts(num_draws)

        def hashed(side, shape):
            if not num_draws:
                return rademacher_fused(salts[side], shape, torch.float32,
                                        device)
            dim = self._draw_dim(len(shape))
            one = list(shape)
            one[dim] //= num_draws
            return rademacher_lanes([pair[side] for pair in salts], one,
                                    torch.float32, device,
                                    axis=dim).reshape(shape)

        if sign_in is None:
            sign_in = hashed(0, x_shape)
        if sign_out is None:
            sign_out = hashed(1, out_shape)
        return sign_in, sign_out

    def _forward_flipout(self, x, normal_scale, default_scale,
                         default_zero_point, sign_in, sign_out):
        num_draws = getattr(self, "_mc_draws", None)
        s_mu = self._mu_scale_f
        if self._calibrated():
            # quant_dict: [eps, delta, x, outputs, sign_in, sign_out,
            #              x_tmp, pert_tmp, perturbed, out]
            (s2, z2), (s3, z3), (s4, z4), (s5, z5), (s6, z6), (s7, z7), \
                (s8, z8), (s9, z9) = (self._qd(i) for i in range(2, 10))
        else:
            s2 = s3 = s4 = s5 = s6 = s7 = s8 = s9 = default_scale
            z2 = z3 = z4 = z5 = z6 = z7 = z8 = z9 = default_zero_point
        delta_q, s1, pert_bias = self._this_draw(normal_scale, num_draws)
        mu_q, mu_b = self.quantized_mu_weight, self.quantized_mu_bias
        x_q = self._quantize_input(x, s2, z2)
        if num_draws:
            x_q = self._tile_draws(x_q, num_draws)
            mu_q, mu_b = _per_draw(mu_q, num_draws), _per_draw(mu_b,
                                                               num_draws)
        outputs_q = self._apply_int8(x_q, s2, z2, mu_q, s_mu, mu_b, s3, z3,
                                     num_draws)
        sign_in, sign_out = self._signs(x_q.shape, outputs_q.shape,
                                        x_q.device, sign_in, sign_out,
                                        num_draws)
        sign_in_q = q.quantize_uint8(sign_in, s4, z4)
        sign_out_q = q.quantize_uint8(sign_out, s5, z5)
        x_tmp_q = q.qmul(x_q, s2, sign_in_q, s4, s6, z6, a_zp=z2, b_zp=z4,
                         out_dtype=torch.uint8)
        pert_q = self._apply_int8(x_tmp_q, s6, z6, delta_q, s1, pert_bias,
                                  s7, z7, num_draws)
        pert_q = q.qmul(pert_q, s7, sign_out_q, s5, s8, z8, a_zp=z7,
                        b_zp=z5, out_dtype=torch.uint8)
        out_q = q.qadd(outputs_q, s3, pert_q, s8, s9, z9, a_zp=z3, b_zp=z8,
                       out_dtype=torch.uint8)
        return self._emit(out_q, s9, z9)

    @torch.no_grad()
    def forward(self, input, return_kl: bool = True, *,
                normal_scale: float = NORMAL_SCALE,
                default_scale: Optional[float] = None,
                default_zero_point: int = 128, sign_in=None, sign_out=None):
        """``default_scale`` None: 0.1 for the legacy classes, 0.2 for the
        others (the reference's two forward signatures). ``sign_in`` /
        ``sign_out`` (Flipout) replace the call's signs."""
        if self.dnn_to_bnn_flag:
            return_kl = False
        if default_scale is None:
            default_scale = 0.1 if self.legacy_ao else 0.2
        if self.estimator == "flipout":
            out = self._forward_flipout(input, normal_scale, default_scale,
                                        default_zero_point, sign_in,
                                        sign_out)
        else:
            out = self._forward_reparam(input, normal_scale, default_scale,
                                        default_zero_point)
        if return_kl:
            return out, 0  # quantized layers carry no KL
        return out

    def __repr__(self):
        return f"{type(self).__name__}()"


class _QuantizedLinearBase(_QuantizedLayerBase):
    is_conv = False

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None):
        self._init_common(generator)
        self.in_features = in_features
        self.out_features = out_features
        self.bias = True


class _QuantizedConvBase(_QuantizedLayerBase):
    is_conv = True
    nd = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 output_padding=0, *,
                 generator: Optional[torch.Generator] = None):
        self._init_common(generator)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = get_kernel_size(kernel_size, self.nd)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.output_padding = output_padding
        self.bias = True
