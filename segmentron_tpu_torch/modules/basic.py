"""Basic conv blocks (counterpart of ``segmentron_tpu/modules/basic.py``).

NCHW modules (the models keep activations in ``channels_last`` memory).
Submodule names follow the JAX package's flax scopes (``conv``/``bn``;
``depthwise``/``dw_bn``/``pointwise``/``pw_bn``) so weights convert
mechanically (``utils/convert.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import (
    bn_amax, bn_folded_affine, fold_and_quantize_weights, qconv, quantize_static,
)
from ..ops.sepconv import (
    WeightCache, fold_sepconv_int8, fused_sepconv_infer_v2, fused_sepconv_infer_v3,
    pack_sepconv, sepconv_vmem_ok, v3_vmem_ok,
)
from .batch_norm import NormConfig

__all__ = ["conv2d", "ConvBNReLU", "SepconvRoutes", "SeparableConv2d", "sepconv_folded"]

_BN_TYPES = ("BN", "SyncBN", "FrozenBN")


def conv2d(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    stride: int = 1,
    padding: Optional[int] = None,
    dilation: int = 1,
    groups: int = 1,
    bias: bool = False,
) -> nn.Conv2d:
    """``nn.Conv2d`` with the reference's default padding
    ``dilation * (k - 1) // 2`` ('same' for odd kernels)."""
    if padding is None:
        padding = dilation * (kernel_size - 1) // 2
    return nn.Conv2d(
        in_channels, out_channels, kernel_size, stride, padding, dilation,
        groups=groups, bias=bias,
    )


class ConvBNReLU(nn.Module):
    """Conv -> norm -> ReLU (``relu=False`` drops the activation)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        dilation: int = 1,
        norm: NormConfig = NormConfig(),
        relu: bool = True,
    ):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride, padding, dilation)
        self.bn = norm.make(out_channels)
        self.act = nn.ReLU() if relu else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


@dataclasses.dataclass(frozen=True)
class SepconvRoutes:
    """Which inference route the separable convs take, from the ``TPU``
    block of the config (``from_cfg``). Modules keep it as ``routes``;
    assigning another one re-routes a built model."""

    fused: bool = False             # USE_PALLAS_SEPCONV: the fused bf16/f32 kernel
    int8: str = ""                  # INT8_ACTIVATIONS: "" or "pw"
    fused_v3: bool = False          # FUSED_SEPCONV_V3: "pw" sum-skip blocks as kernel chains
    entry_v3: Tuple[str, ...] = ()  # FUSED_ENTRY_V3: conv-skip blocks opted in by name
    min_bytes: int = 80 * 1024 * 1024  # FUSED_SEPCONV_MIN_BYTES
    int8_k: float = 6.0             # INT8_K

    @classmethod
    def from_cfg(cls, cfg) -> "SepconvRoutes":
        t = cfg.TPU
        return cls(
            fused=bool(t.USE_PALLAS_SEPCONV),
            int8="pw" if t.INT8_ACTIVATIONS == "pw" else "",
            fused_v3=bool(t.FUSED_SEPCONV_V3),
            entry_v3=tuple(s.strip() for s in str(t.FUSED_ENTRY_V3).split(",") if s.strip()),
            min_bytes=int(t.FUSED_SEPCONV_MIN_BYTES),
            int8_k=float(t.INT8_K),
        )


def sepconv_folded(sep: "SeparableConv2d"):
    """(dw (3,3,1,C) f32, a1, c1, pw (1,1,C,Co), a2, c2) of a separable
    conv: the JAX layouts of its weights and both BNs as f32 affines."""
    a1, c1 = bn_folded_affine(sep.dw_bn.weight, sep.dw_bn.bias, sep.dw_bn.running_mean,
                              sep.dw_bn.running_var, sep.dw_bn.eps)
    a2, c2 = bn_folded_affine(sep.pw_bn.weight, sep.pw_bn.bias, sep.pw_bn.running_mean,
                              sep.pw_bn.running_var, sep.pw_bn.eps)
    dw = sep.depthwise.weight.permute(2, 3, 1, 0).float()
    pw = sep.pointwise.weight.permute(2, 3, 1, 0)
    return dw, a1, c1, pw, a2, c2


class SeparableConv2d(nn.Module):
    """[ReLU] -> depthwise 3x3 -> norm -> pointwise 1x1 -> norm.

    ``relu_first=False`` is the aligned-Xception order (no ReLU inside);
    the stride and dilation apply to the depthwise conv.

    Eval routes, gated as in the JAX package less its backend check (on
    the CPU the kernels' wrappers compute their plain versions):

    - ``routes.int8 == "pw"``: the dw->pw hop is quantized to int8 and
      the pointwise product runs s8 x s8 (``ops/quant.py``). Inside a
      block that runs as a kernel chain (``forward(x, chain=True)``) and
      with ``routes.fused_v3``, the whole layer is one launch of the
      fused kernel with ``int8_dot`` (``ops/sepconv.py``).
    - ``routes.fused``: stride-1 3x3 layers whose shape the reference's
      formula admits run the fused kernel in the input's dtype.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        norm: NormConfig = NormConfig(),
        relu_first: bool = True,
        routes: SepconvRoutes = SepconvRoutes(),
    ):
        super().__init__()
        self.relu_first = relu_first
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.out_channels = out_channels
        self.norm = norm
        self.routes = routes
        self._cache = WeightCache()
        self.depthwise = conv2d(
            in_channels, in_channels, kernel_size, stride, None, dilation,
            groups=in_channels,
        )
        self.dw_bn = norm.make(in_channels)
        self.pointwise = conv2d(in_channels, out_channels, 1, 1, 0)
        self.pw_bn = norm.make(out_channels)

    # ------------------------------------------------------------- gates
    def _tile_h(self, h, w, c, d):
        for tile in (16, 8, 4):
            if h % tile == 0 and h >= tile + 2 * d and sepconv_vmem_ok(
                h, w, c, self.out_channels, d, tile_h=tile
            ):
                return tile
        return None

    def _fusable(self, x) -> bool:
        """The JAX package's gate of the ``USE_PALLAS_SEPCONV`` route."""
        if self.training or not self.routes.fused:
            return False
        if self.kernel_size != 3 or self.stride != 1 or self.norm.bn_type not in _BN_TYPES:
            return False
        n, c, h, w = x.shape
        return self._tile_h(h, w, c, self.dilation) is not None

    def _int8_pw_mode(self) -> bool:
        return (not self.training and self.routes.int8 == "pw"
                and self.norm.bn_type in _BN_TYPES)

    def _v3_tile(self, x, chain: bool) -> Optional[int]:
        """The JAX package's tile choice for the fused int8 kernel, or
        None for the unfused "pw" path: only layers of a block that runs
        as a kernel chain take the kernel."""
        if not chain or not self.routes.fused_v3:
            return None
        if self.kernel_size != 3 or self.stride != 1:
            return None
        n, c, h, w = x.shape
        d = self.dilation
        for tile in (8, 4):
            if (tile % d == 0 and h % tile == 0 and h >= 2 * tile
                    and v3_vmem_ok(h, w, c, self.out_channels, d, tile)):
                return tile
        return None

    # ------------------------------------------------------------ routes
    def _weights(self):
        return [*self.parameters(), *self.buffers()]

    def _cached(self, tag, x, build):
        return self._cache.get((tag, x.dtype, x.device), self._weights(), build)

    def _fused_args(self, x, int8: bool):
        """(the fused kernel's weight arguments, their packed buffers or
        None on the CPU) for the NHWC input ``x``."""
        def build():
            dw, a1, c1, pw, a2, c2 = sepconv_folded(self)
            if int8:
                ms, mb, wq, osc = fold_sepconv_int8(a1, c1, pw, a2, k_sigma=self.routes.int8_k)
                args = (dw, ms, mb, wq, osc, c2)
            else:
                args = (dw, a1, c1, pw, a2, c2)
            packed = pack_sepconv(x, *args, int8_dot=int8) if x.is_cuda else None
            return args, packed

        return self._cached(("fused", int8, self.routes.int8_k), x, build)

    def _int8_pw_forward(self, x, chain: bool):
        """Depthwise in the input's dtype with f32 sums -> folded BN ->
        int8 -> s8 x s8 pointwise -> folded BN -> the input's dtype; or,
        in a kernel chain, the same in one launch of the fused kernel,
        where neither the depthwise result nor its int8 copy reaches
        device memory."""
        tile = self._v3_tile(x, chain)
        if tile is not None:
            nhwc = x.permute(0, 2, 3, 1).contiguous()
            args, packed = self._fused_args(nhwc, int8=True)
            y = fused_sepconv_infer_v3(
                nhwc, *args, dilation=self.dilation, pre_relu=self.relu_first,
                tile_h=tile, int8_dot=True, packed=packed,
            )
            return y.permute(0, 3, 1, 2)

        def build():
            dw, a1, c1, pw, a2, c2 = sepconv_folded(self)
            amax = bn_amax(a1, c1, k=self.routes.int8_k)
            taps = self.depthwise.weight.to(x.dtype).float()
            quantized = fold_and_quantize_weights(pw, (amax / 127.0).float())
            return taps, a1, c1, amax, pw, quantized, (a2, c2)

        taps, a1, c1, amax, pw, quantized, affine = self._cached(
            ("pw", self.routes.int8_k), x, build)
        if self.relu_first:
            x = x.relu()
        dw = self.depthwise
        # f32 sums of the products in the input's dtype, kept unrounded
        # into the BN fold and the quantizer
        y = F.conv2d(x.float(), taps, None, dw.stride, dw.padding, dw.dilation, dw.groups)
        y = y.permute(0, 2, 3, 1) * a1 + c1
        out = qconv(quantize_static(y, amax), pw, bn_affine=affine, quantized=quantized)
        return out.to(x.dtype).permute(0, 3, 1, 2)

    def forward(self, x, chain: bool = False):
        if self._int8_pw_mode():
            return self._int8_pw_forward(x, chain)
        if self._fusable(x):
            n, c, h, w = x.shape
            nhwc = x.permute(0, 2, 3, 1).contiguous()
            args, packed = self._fused_args(nhwc, int8=False)
            y = fused_sepconv_infer_v2(
                nhwc, *args, dilation=self.dilation, pre_relu=self.relu_first,
                tile_h=self._tile_h(h, w, c, self.dilation), packed=packed,
            )
            return y.permute(0, 3, 1, 2)
        if self.relu_first:
            x = x.relu()
        x = self.dw_bn(self.depthwise(x))
        return self.pw_bn(self.pointwise(x))
