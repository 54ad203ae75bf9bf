"""BN folding and static int8 quantization for the inference path
(counterpart of ``segmentron_tpu/ops/quant.py``).

Two users. The "pw" serving mode (``cfg.TPU.INT8_ACTIVATIONS="pw"``)
quantizes the depthwise result of a separable conv to int8 with a static
per-channel range derived from the BN that produced it
(``amax_c = |bias_c| + K*|scale_c|``) and runs the pointwise product
s8 x s8 -> s32. ``cfg.TPU.INT8_RESNET`` runs the ResNet blocks' 3x3 and
1x1 interior convolutions the same way (``qconv`` with any kernel size,
stride, dilation and padding; ``models/backbones/resnet.py``). In both
the producer's scales are folded into the consumer's weights before
their per-output-channel quantization, and the scales come back in an
f32 epilogue. The full-int8 mode's ``qadd`` and ``qrelu``, depthwise
``qconv`` (``groups > 1``) and calibration (``observe_amax``,
``site_amax``) are not ported yet.

Arrays are NHWC with per-channel (last-dim) scales, as in the JAX
package. A convolution is one (M, kh*kw*C) x (kh*kw*C, O) product over
the gathered taps of the zero-padded input (``im2col``). The s8 x s8
product is exact (``int8_matmul_acc``): on a CUDA tensor
``torch._int_mm`` (the JAX package's XLA convolution with int32
accumulation; no Pallas kernel) with the weight column-major, the
operands zero-padded to a shape it takes, which adds nothing to any sum;
on a CPU tensor a float64 product, exact since every sum here is below
2**53 (an f32 product is not: 127 * 127 * 2048 > 2**24).
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
    "im2col",
    "int8_matmul",
    "int8_matmul_acc",
    "int_mm_shape",
    "matmul_weights",
    "pad_for_int_mm",
    "qconv",
    "qconv_acc",
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


_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: M > 16, K and N multiples of 8


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def int_mm_shape(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The least (M, K, N) at or above ``(m, k, n)`` that ``torch._int_mm``
    takes on CUDA."""
    return max(m, _INT_MM_MIN_ROWS), _round_up(k, 8), _round_up(n, 8)


def matmul_weights(w_q) -> torch.Tensor:
    """int8 HWIO weights -> the (kh*kw*I, O) product operand, column-major
    (the layout in which ``torch._int_mm`` reads its second operand
    fastest: 0.0428 against 0.0767 ms at (8192, 728, 728) on an H100)."""
    return w_q.reshape(-1, w_q.shape[-1]).t().contiguous().t()


def pad_for_int_mm(a, b):
    """(a, b) zero-padded up to ``int_mm_shape``: a (M, K) -> (M', K'),
    b (K, N) -> (K', N') column-major. The zeros add nothing to any sum,
    so the product cut back to (M, N) is the product of ``a`` and ``b``."""
    (m, k), n = a.shape, b.shape[1]
    pm, pk, pn = int_mm_shape(m, k, n)
    if (pm, pk) != (m, k):
        a = torch.nn.functional.pad(a, (0, pk - k, 0, pm - m))
    if (pk, pn) != (k, n):
        b = torch.nn.functional.pad(b.t(), (0, pk - k, 0, pn - n)).t()
    return a, b


def int8_matmul_acc(a, b) -> torch.Tensor:
    """Exact (M,K) s8 x (K,N) s8 -> (M,N) int32 (every sum of the sizes
    used here is below 2**31).

    A CUDA tensor takes ``torch._int_mm``, its operands zero-padded to a
    shape that call takes where they are not one (``pad_for_int_mm``: M
    <= 16, K or N not a multiple of 8) and the result cut back. A CPU
    tensor takes the plain version, a float64 product."""
    m, n = a.shape[0], b.shape[1]
    if a.is_cuda:
        a, b = pad_for_int_mm(a, b)
        acc = torch._int_mm(a.contiguous(), b)
        return acc[:m, :n] if acc.shape != (m, n) else acc
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(a, b):
    """``int8_matmul_acc`` as f32 (its cast rounds as the JAX package's
    ``astype(float32)`` does)."""
    return int8_matmul_acc(a, b).float()


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(e) for e in v)


def im2col(q, kernel: Tuple[int, int], stride=1, padding=None, dilation=1):
    """(N, H, W, C) int8 -> ((N*Ho*Wo, kh*kw*C) taps, (N, Ho, Wo)): the
    input zero-padded by ``padding`` (None: ``d*(k-1)//2``, 'same' for odd
    kernels), the taps in HWIO order, tap (i, j) of output (y, x) at input
    row ``y*s + i*d - p`` and column ``x*s + j*d - p``."""
    kh, kw = kernel
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    if padding is None:
        padding = (dh * (kh - 1) // 2, dw * (kw - 1) // 2)
    ph, pw = _pair(padding)
    n, h, w, c = q.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if ph or pw:
        padded = q.new_zeros((n, h + 2 * ph, w + 2 * pw, c))
        padded[:, ph:ph + h, pw:pw + w] = q
    else:
        padded = q
    taps = [padded[:, i * dh: i * dh + sh * (ho - 1) + 1: sh,
                   j * dw: j * dw + sw * (wo - 1) + 1: sw]
            for i in range(kh) for j in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    return cols.reshape(n * ho * wo, kh * kw * c), (n, ho, wo)


def qconv_acc(q, w_mat, kernel: Tuple[int, int], stride=1, padding=None, dilation=1):
    """The int32 accumulators of an int8 convolution: (N, H, W, C) int8
    ``q`` and the (kh*kw*C, O) int8 ``w_mat`` (``matmul_weights``) ->
    (N, Ho, Wo, O) int32."""
    cols, (n, ho, wo) = im2col(q, kernel, stride, padding, dilation)
    return int8_matmul_acc(cols, w_mat).reshape(n, ho, wo, w_mat.shape[1])


def qconv(x: QTensor, w, stride=1, padding=None, dilation=1, groups: int = 1,
          bn_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          relu: bool = False, out_amax=None, quantized=None):
    """int8 convolution with a fused f32 epilogue: int32 accumulators,
    then the weight scales (input scales are folded into the weights
    first), the folded BN affine, optional ReLU and, when ``out_amax`` is
    given, the requantization to a ``QTensor``; else an f32 NHWC array.

    ``w`` is HWIO ``(kh, kw, C, O)``; ``padding`` an int, a pair or None
    for ``d*(k-1)//2``. ``quantized``: the ``(w_q, s_w)`` pair of a caller
    that keeps it between calls, ``w_q`` as HWIO or as ``matmul_weights``
    gives it. Depthwise and grouped convolutions (``groups > 1``) are not
    ported and raise ``NotImplementedError``."""
    if groups != 1:
        raise NotImplementedError("qconv: grouped int8 convolutions are not ported to PyTorch")
    kernel = tuple(int(v) for v in w.shape[:2])
    w_q, s_w = quantized if quantized is not None else fold_and_quantize_weights(w, x.scale)
    if w_q.dim() == 4:
        w_q = matmul_weights(w_q)
    acc = qconv_acc(x.q, w_q, kernel, stride, padding, dilation)
    y = acc.float() * s_w
    if bn_affine is not None:
        a, b = bn_affine
        y = y * a + b
    if relu:
        y = torch.relu(y)
    if out_amax is None:
        return y
    return quantize_static(y, out_amax)
