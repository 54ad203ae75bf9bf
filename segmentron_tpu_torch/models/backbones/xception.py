"""Aligned Xception-65 backbone (counterpart of
``segmentron_tpu/models/backbones/xception.py``).

Entry flow (stride-2 separable-conv blocks with 1x1-conv residuals), a
middle flow of ``middle_blocks`` sum-skip blocks (16 in Xception-65),
and a dilated exit flow. ``output_stride`` picks which strides become
dilations:

- OS16: entry block3 stride 2, middle dilation 1, exit dilations (1, 2)
- OS8:  entry block3 stride 1, middle dilation 2, exit dilations (2, 4)

Taps: c1 = entry block1 (128ch, /4), c2 = block2 (256ch, /8), c3 =
middle-flow out (728ch), c4 = exit (2048ch). NCHW in and out.

In eval the stem and block1 can run as one fused kernel
(``ops/entrychain.py``), under the JAX package's gate:
``fused_stem`` "block1" or "stem" (``cfg.TPU.FUSED_STEM``), BN-type
norms, and the kernels' supported geometry. The gate does not depend on
the device; on the CPU the kernels' wrappers compute their plain
versions.

In the int8 "pw" serving mode (``SepconvRoutes``: ``int8="pw"`` with
``fused_v3`` or a block named in ``entry_v3``) a whole ``XceptionBlock``
can run as a chain of fused separable-conv kernels
(``ops/sepconv.py``): sep1 and sep2 through ``fused_sepconv_infer_v3``
and sep3 plus the residual through ``fused_sepconv_infer_v3_skip``,
under the JAX package's gate (``XceptionBlock._fused_chain``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ...modules import NormConfig, SeparableConv2d, SepconvRoutes, conv2d
from ...modules.basic import ConvBNReLU, sepconv_folded
from ...ops.entrychain import (
    fused_stem, fused_stem_block1, pack_weights, stem_block1_supported, stem_supported,
)
from ...ops.quant import bn_folded_affine
from ...ops.sepconv import (
    WeightCache, fold_sepconv_int8, fused_sepconv_infer_v3_skip, pack_sepconv, v3_skip_vmem_ok,
)
from .build import BACKBONE_REGISTRY

__all__ = ["Xception65", "XceptionBlock"]


class XceptionBlock(nn.Module):
    """Three separable convs with an additive skip: ``skip_type='conv'``
    a strided 1x1 conv + norm, ``'sum'`` the identity. The last
    separable conv carries the block stride. ``name`` is the block's
    name in the backbone, which ``routes.entry_v3`` may list."""

    def __init__(self, in_channels: int, channels: Sequence[int], stride: int = 1,
                 dilation: int = 1, skip_type: str = "conv", relu_first: bool = True,
                 norm: NormConfig = NormConfig(), routes: SepconvRoutes = SepconvRoutes(),
                 name: str = ""):
        super().__init__()
        self.skip_type = skip_type
        self.channels = tuple(channels)
        self.stride, self.dilation, self.relu_first = stride, dilation, relu_first
        self.norm = norm
        self.routes = routes
        self.name = name
        self._cache = WeightCache()
        cin = in_channels
        for i, ch in enumerate(channels):
            s = stride if i == len(channels) - 1 else 1
            setattr(self, f"sep{i + 1}", SeparableConv2d(
                cin, ch, 3, stride=s, dilation=dilation, norm=norm, relu_first=relu_first,
                routes=routes,
            ))
            cin = ch
        self.n_sep = len(channels)
        if skip_type == "conv":
            self.skip_conv = conv2d(in_channels, channels[-1], 1, stride, 0)
            self.skip_bn = norm.make(channels[-1])
        elif skip_type != "sum":
            raise ValueError(f"unsupported skip_type {skip_type!r}")

    def _fused_chain(self, x) -> bool:
        """True when the whole block runs as one chain of fused kernels:
        the JAX package's gate less its backend check. Eval, "pw" int8
        mode, and either a sum-skip block whose activations reach
        ``routes.min_bytes`` (``fused_v3``) or a conv-skip block opted
        in by name (``entry_v3``); all or nothing per block."""
        routes = self.routes
        if self.training:
            return False
        entry_v3 = self.name in routes.entry_v3
        if routes.int8 != "pw" or not (routes.fused_v3 or entry_v3):
            return False
        if self.norm.bn_type not in ("BN", "SyncBN", "FrozenBN"):
            return False
        n, c, h, w = x.shape
        if entry_v3:
            if self.skip_type != "conv":
                return False
        elif self.skip_type != "sum" or self.stride != 1:
            return False
        elif c != self.channels[-1]:
            return False
        t_in = 2 * self.stride * self.dilation  # the reference's smallest viable tile
        if h % t_in or w % self.stride or h < 2 * t_in:
            return False
        if not entry_v3 and h * w * (c + self.channels[0]) * 2 < routes.min_bytes:
            return False
        return self._end_tile(h, w, self.channels[-2], c, self.channels[-1]) is not None

    def _end_tile(self, h, w, c, cin, co):
        d, s = self.dilation, self.stride
        for t_out in (8, 4, 2):
            t_in = s * t_out
            if (t_in % d == 0 and h % t_in == 0 and h >= 2 * t_in
                    and v3_skip_vmem_ok(h, w, c, cin, co, d, s, t_out)):
                return t_out
        return None

    def _end_args(self, y):
        """(the block-end kernel's weight arguments, their packed
        buffers or None on the CPU) for the NHWC input ``y`` of the last
        separable conv."""
        last = getattr(self, f"sep{self.n_sep}")
        tensors = [*last.parameters(), *last.buffers()]
        if self.skip_type == "conv":
            tensors += [*self.skip_conv.parameters(), *self.skip_bn.parameters(),
                        *self.skip_bn.buffers()]

        def build():
            dw, a1, c1, pw, a2, c2 = sepconv_folded(last)
            ms, mb, wq, osc = fold_sepconv_int8(a1, c1, pw, a2, k_sigma=self.routes.int8_k)
            args = (dw, ms, mb, wq, osc, c2)
            if self.skip_type == "conv":
                bn = self.skip_bn
                sa, sc = bn_folded_affine(bn.weight, bn.bias, bn.running_mean,
                                          bn.running_var, bn.eps)
                args += (self.skip_conv.weight.permute(2, 3, 1, 0), sa, sc)
            return args, pack_sepconv(y, *args[:6], True, *args[6:]) if y.is_cuda else None

        return self._cache.get((y.dtype, y.device, self.routes.int8_k), tensors, build)

    def _fused_forward(self, x):
        """The whole block as one chain of kernels: all but the last
        separable conv through the fused int8 kernel (``chain=True``),
        the last one and the residual through the block-end kernel."""
        y = x
        for i in range(self.n_sep - 1):
            y = getattr(self, f"sep{i + 1}")(y, chain=True)
        n, c, h, w = y.shape
        tile = self._end_tile(h, w, c, x.shape[1], self.channels[-1])
        assert tile is not None, "_fused_chain gate must ensure a viable tile"
        y = y.permute(0, 2, 3, 1).contiguous()
        args, packed = self._end_args(y)
        out = fused_sepconv_infer_v3_skip(
            y, x.permute(0, 2, 3, 1).contiguous(), *args, dilation=self.dilation,
            stride=self.stride, pre_relu=self.relu_first, tile_out=tile, int8_dot=True,
            skip=self.skip_type, packed=packed,
        )
        return out.permute(0, 3, 1, 2)  # NHWC-contiguous = channels_last NCHW

    def forward(self, x):
        if self._fused_chain(x):
            return self._fused_forward(x)
        y = x
        for i in range(self.n_sep):
            y = getattr(self, f"sep{i + 1}")(y)
        if self.skip_type == "conv":
            return y + self.skip_bn(self.skip_conv(x))
        return y + x


def _folded(conv_w: torch.Tensor, bn) -> Tuple[torch.Tensor, ...]:
    """(HWIO weight, a, b) of a conv followed by a BN, in the entry
    kernels' argument layout."""
    a, b = bn_folded_affine(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return conv_w.permute(2, 3, 1, 0), a, b


class Xception65(nn.Module):
    def __init__(self, output_stride: int = 16, middle_blocks: int = 16,
                 norm: NormConfig = NormConfig(), fused_stem="block1",
                 routes: SepconvRoutes = SepconvRoutes()):
        super().__init__()
        if output_stride == 16:
            entry3_stride, middle_dilation, exit_dilations = 2, 1, (1, 2)
        elif output_stride == 8:
            entry3_stride, middle_dilation, exit_dilations = 1, 2, (2, 4)
        else:
            raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")
        self.norm = norm
        self.fused_stem = fused_stem
        self._entry_cache = None  # see _entry_weights
        self.conv1 = ConvBNReLU(3, 32, 3, 2, norm=norm)
        self.conv2 = ConvBNReLU(32, 64, 3, 1, norm=norm)
        self.block1 = XceptionBlock(64, (128, 128, 128), 2, norm=norm, relu_first=False,
                                    routes=routes, name="block1")
        self.block2 = XceptionBlock(128, (256, 256, 256), 2, norm=norm, routes=routes,
                                    name="block2")
        self.block3 = XceptionBlock(256, (728, 728, 728), entry3_stride, norm=norm,
                                    routes=routes, name="block3")
        self.middle_blocks = middle_blocks
        for i in range(middle_blocks):
            setattr(self, f"middle{i + 1}", XceptionBlock(
                728, (728, 728, 728), 1, dilation=middle_dilation, skip_type="sum",
                norm=norm, routes=routes, name=f"middle{i + 1}",
            ))
        self.exit1 = XceptionBlock(728, (728, 1024, 1024), 1, dilation=exit_dilations[0],
                                   norm=norm, routes=routes, name="exit1")
        cin = 1024
        for i, ch in enumerate((1536, 1536, 2048)):
            setattr(self, f"exit_sep{i + 1}", SeparableConv2d(
                cin, ch, 3, dilation=exit_dilations[1], norm=norm, relu_first=False,
                routes=routes,
            ))
            cin = ch

    def _fused_stem_mode(self, x) -> str:
        """'' (off) | 'stem' | 'block1': the JAX package's gate
        (``Xception65._fused_stem_mode``) less its backend check."""
        if self.training:
            return ""
        mode = self.fused_stem
        if not mode:
            return ""
        if mode is True:
            mode = "stem"
        elif mode not in ("stem", "block1"):
            return ""  # unknown spelling = off, never a silent "stem"
        if self.norm.bn_type not in ("BN", "SyncBN", "FrozenBN"):
            return ""
        n, c, h, w = x.shape
        if mode == "block1":
            return "block1" if stem_block1_supported(h, w, c) else ""
        return "stem" if stem_supported(h, w, c) else ""

    def _entry_weights(self, mode, x):
        """(folded weights, their packed kernel buffer or None) of the
        fused entry for input ``x``. Folding and packing take ~80 small
        launches, so the result is kept until a weight is replaced or
        changed in place (its storage or version counter moves)."""
        b1 = self.block1
        modules = [self.conv1, self.conv2]
        if mode == "block1":
            modules += [b1.sep1, b1.sep2, b1.sep3, b1.skip_conv, b1.skip_bn]
        tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
        key = (mode, x.dtype, x.device, tuple((t.data_ptr(), t._version) for t in tensors))
        if self._entry_cache is None or self._entry_cache[0] != key:
            stem_p = (_folded(self.conv1.conv.weight, self.conv1.bn)
                      + _folded(self.conv2.conv.weight, self.conv2.bn))
            if mode == "stem":
                weights = (stem_p,)
            else:
                sep_p = tuple(
                    _folded(s.depthwise.weight, s.dw_bn) + _folded(s.pointwise.weight, s.pw_bn)
                    for s in (b1.sep1, b1.sep2, b1.sep3)
                )
                weights = (stem_p, sep_p, _folded(b1.skip_conv.weight, b1.skip_bn))
            packed = pack_weights(x, *weights) if x.is_cuda else None
            self._entry_cache = (key, weights, packed)
        return self._entry_cache[1], self._entry_cache[2]

    def _entry(self, x, mode):
        """The stem (and block1) through the fused kernels."""
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        weights, packed = self._entry_weights(mode, nhwc)
        if mode == "stem":
            y = fused_stem(nhwc, *weights[0], packed=packed)
        else:
            y = fused_stem_block1(nhwc, *weights, packed=packed)
        return y.permute(0, 3, 1, 2)  # NHWC-contiguous = channels_last NCHW

    def forward(self, x):
        mode = self._fused_stem_mode(x)
        if mode:
            x = self._entry(x, mode)
        else:
            x = self.conv2(self.conv1(x))
        if mode != "block1":
            x = self.block1(x)
        c1 = x
        c2 = x = self.block2(x)
        x = self.block3(x)
        for i in range(self.middle_blocks):
            x = getattr(self, f"middle{i + 1}")(x)
        c3 = x
        x = self.exit1(x)
        for i in range(3):
            x = getattr(self, f"exit_sep{i + 1}")(x).relu()
        return c1, c2, c3, x


@BACKBONE_REGISTRY.register(name="xception65")
def _xception65(norm: NormConfig):
    from ...config import cfg

    return Xception65(
        output_stride=int(cfg.MODEL.OUTPUT_STRIDE),
        middle_blocks=int(cfg.MODEL.XCEPTION.MIDDLE_BLOCKS),
        norm=norm,
        fused_stem=cfg.TPU.FUSED_STEM,
        routes=SepconvRoutes.from_cfg(cfg),
    )
