"""BN folding and static int8 quantization for the inference path
(counterpart of ``segmentron_tpu/ops/quant.py``).

What the "pw" serving mode needs (``cfg.TPU.INT8_ACTIVATIONS="pw"``):
the depthwise result of a separable conv is quantized to int8 with a
static per-channel range derived from the BN that produced it
(``amax_c = |bias_c| + K*|scale_c|``), the producer's scales are folded
into the pointwise weights before their per-output-channel
quantization, and the pointwise product runs s8 x s8 -> s32 with the
scales applied in an f32 epilogue. The full-int8 mode's ``qadd`` and
``qrelu``, calibration (``observe_amax``, ``site_amax``) and ``qconv``
beyond the 1x1 hop are not ported yet.

Arrays are NHWC with per-channel (last-dim) scales, as in the JAX
package. The s8 x s8 product is exact: ``torch._int_mm`` on a CUDA
tensor whose shape it takes, a float64 product otherwise (an f32
product is not exact: 127 * 127 * 2048 > 2**24).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "QTensor",
    "bn_amax",
    "bn_folded_affine",
    "dequantize",
    "fold_and_quantize_weights",
    "int8_matmul",
    "qconv",
    "quantize_static",
]


class QTensor(NamedTuple):
    """int8 activations + static per-channel (last-dim) f32 scale."""

    q: torch.Tensor      # int8, NHWC
    scale: torch.Tensor  # (C,) f32; dequantized = q * scale


def bn_folded_affine(scale, bias, mean, var, eps: float):
    """Inference BN as ``y = a*x + b``, computed in f32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return a, b


def bn_amax(a, b, k: float = 6.0, floor: float = 1e-3):
    """Per-channel |max| estimate of a post-BN activation: the affine
    output of a ~N(0,1) variable is ~N(b_c, a_c^2), bounded at k sigma
    by ``|b_c| + k*|a_c|``."""
    return torch.clamp(b.abs() + k * a.abs(), min=floor)


def quantize_static(x, amax) -> QTensor:
    """f32/bf16 NHWC -> int8 with the given per-channel amax (round
    half to even, clip to +-127)."""
    scale = (amax / 127.0).float()
    q = torch.clamp(torch.round(x.float() / scale), -127.0, 127.0).to(torch.int8)
    return QTensor(q, scale)


def dequantize(t: QTensor, dtype=torch.float32):
    return (t.q.float() * t.scale).to(dtype)


def fold_and_quantize_weights(w, in_scale, groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the producer's per-input-channel scales into f32 HWIO
    weights, then per-output-channel symmetric int8 quantization.
    Returns (w_q int8 HWIO, s_w (O,) f32). For depthwise convs
    (groups == C, I == 1) the fold runs over the O axis."""
    w = w.float()
    if groups == 1:
        w_eff = w * in_scale[None, None, :, None]
    else:
        mult = w.shape[-1] // groups
        w_eff = w * torch.repeat_interleave(in_scale, mult)[None, None, None, :]
    s_w = torch.clamp(w_eff.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w_eff / s_w), -127.0, 127.0).to(torch.int8)
    return w_q, s_w


def int8_matmul(a, b):
    """Exact (M,K) s8 x (K,N) s8 product as f32 (every s32 sum of the
    sizes used here is below 2**31; its cast to f32 rounds as the JAX
    package's ``astype(float32)`` does)."""
    m, k = a.shape
    if a.is_cuda and m > 16 and k % 8 == 0 and b.shape[1] % 8 == 0:
        return torch._int_mm(a.contiguous(), b).float()
    return (a.double() @ b.double()).float()


def qconv(x: QTensor, w, stride=1, padding=0, dilation=1, groups: int = 1,
          bn_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          relu: bool = False, out_amax=None, quantized=None):
    """int8 1x1 convolution with a fused f32 epilogue: the weight scales
    (input scales are folded into the weights first), the folded BN
    affine, optional ReLU and, when ``out_amax`` is given, the
    requantization to a ``QTensor``; else an f32 NHWC array.

    ``w`` is HWIO ``(1, 1, C, O)``. ``quantized``: the
    ``fold_and_quantize_weights(w, x.scale)`` pair of a caller that keeps
    it between calls. Only the pointwise hop of the "pw" mode is ported:
    any other kernel size, stride, padding, dilation or group count
    raises ``NotImplementedError``."""
    if (tuple(w.shape[:2]) != (1, 1) or stride not in (1, (1, 1)) or padding not in (0, (0, 0))
            or dilation not in (1, (1, 1)) or groups != 1):
        raise NotImplementedError("qconv: only the 1x1 stride-1 hop is ported to PyTorch")
    w_q, s_w = quantized if quantized is not None else fold_and_quantize_weights(w, x.scale)
    c, o = w_q.shape[-2:]
    acc = int8_matmul(x.q.reshape(-1, c), w_q.reshape(c, o))
    y = acc.reshape(*x.q.shape[:-1], o) * s_w
    if bn_affine is not None:
        a, b = bn_affine
        y = y * a + b
    if relu:
        y = torch.relu(y)
    if out_amax is None:
        return y
    return quantize_static(y, out_amax)
