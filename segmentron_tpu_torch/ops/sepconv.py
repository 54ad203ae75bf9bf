"""Fused separable-conv inference: one hand-written CUDA kernel family
(``csrc/sepconv.cu``) behind the four entry points of
``segmentron_tpu/ops/sepconv.py``.

Replaces the Pallas kernels ``_kernel`` (``fused_sepconv_infer``),
``_kernel_v2`` (``fused_sepconv_infer_v2``), ``_kernel_v3``
(``fused_sepconv_infer_v3``) and ``_kernel_v3_skip``
(``fused_sepconv_infer_v3_skip``), with the same arguments. They all
compute one function family on NHWC arrays, bf16 or f32::

    [relu] -> depthwise 3x3 (dilation d, stride 1|2, zero pad d) in f32
           -> * mid_scale + mid_bias
           -> [round half to even, clip +-127, int8]          (int8_dot)
           -> pointwise product (bf16*bf16->f32 | f32*f32->f32 | s8*s8->s32)
           -> * out_scale + out_bias
           -> [+ (x_in . skip_w) * skip_scale + skip_bias | + x_in]
           -> cast to x.dtype

Inference only, both BNs folded into per-channel affines by the caller.
With ``int8_dot`` the caller passes the mid affine pre-divided by the
requantization scale, int8 pointwise weights and an ``out_scale`` that
carries the weight scales (``fold_sepconv_int8``).

Bound on one H100 for a middle-flow layer of Xception-65 at output
stride 8, (1,128,256,728) -> 728: 95.4 MB moved and 34.7 GFLOP, so
0.0351 ms in bf16 (operations) and 0.0285 ms with ``int8_dot`` (bytes).
Where the depthwise result of a block's 8 x 16 pixels fits in shared
memory (bf16 and int8 products), it is computed once and the tiles of
128 output channels run against it; f32 products, and larger shapes,
recompute it per tile. The design and what keeps it from the bound
(the taps' instruction count on the CUDA cores, shared-memory bandwidth
under ``mma.sync``, one block of 8 warps per SM) are described in the
source.

``sepconv_vmem_ok``, ``v3_vmem_ok`` and ``v3_skip_vmem_ok`` are the JAX
package's admission formulas, kept as routing gates so that the port
routes layer for layer as the reference does; ``tile_h``, ``tile_out``
and ``interpret`` are accepted and not read (the CUDA kernel's tiling
is its own, and it needs no divisibility of H or W).

Each wrapper launches the kernel for a CUDA tensor, or raises; it takes
its plain PyTorch version (``*_plain``: the same steps with the same
casts, in the kernel's order) only for a CPU tensor.
``<wrapper>.launches`` counts kernel launches. ``pack_sepconv`` lays the
weights out for the kernel; a caller that runs the same weights many
times packs once and passes ``packed=``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .kernels import library
from .quant import bn_amax, fold_and_quantize_weights, int8_matmul

__all__ = [
    "PackedSepconv",
    "WeightCache",
    "fold_sepconv_int8",
    "fused_sepconv_infer",
    "fused_sepconv_infer_plain",
    "fused_sepconv_infer_v2",
    "fused_sepconv_infer_v2_plain",
    "fused_sepconv_infer_v3",
    "fused_sepconv_infer_v3_plain",
    "fused_sepconv_infer_v3_skip",
    "fused_sepconv_infer_v3_skip_plain",
    "pack_sepconv",
    "sepconv_vmem_ok",
    "v3_skip_vmem_ok",
    "v3_vmem_ok",
]

_PAD_IN, _PAD_OUT = 32, 128  # csrc/sepconv.cu: channel chunk, output-channel tile
_SKIP_CODES = {None: 0, "conv": 1, "sum": 2}


def fold_sepconv_int8(mid_scale, mid_bias, pw_kernel, out_scale, k_sigma: float = 6.0):
    """Fold the dw->pw requantization scale for the ``int8_dot`` path:
    the mid affine absorbs ``1/s_mid`` (so the kernel only rounds), the
    pointwise weights are per-out-channel int8 with the per-in-channel
    ``s_mid`` folded in first, and the weight scales ride out on the
    output affine. Same static ``bn_amax`` ranges as the unfused "pw"
    path. Returns (mid_scale, mid_bias, w_q (C, Co) int8, out_scale)."""
    c = pw_kernel.shape[-2] if pw_kernel.dim() == 4 else pw_kernel.shape[0]
    pw = pw_kernel.reshape(c, -1)
    s_mid = bn_amax(mid_scale, mid_bias, k=k_sigma) / 127.0
    w_q, s_w = fold_and_quantize_weights(pw[None, None].float(), s_mid)
    return mid_scale / s_mid, mid_bias / s_mid, w_q.reshape(c, -1), out_scale.float() * s_w


# ------------------------------------------------------------ routing gates
def sepconv_vmem_ok(h: int, w: int, c: int, c_out: int, dilation: int,
                    dtype_bytes: int = 2, tile_h: int = 8,
                    budget: int = 12 * 1024 * 1024) -> bool:
    """The JAX package's admission formula of ``fused_sepconv_infer_v2``."""
    d = dilation
    blocks = 2 * (tile_h + 2 * d) * w * c * dtype_bytes
    acc = (tile_h + 2 * d) * (w + 2 * d) * c * 4
    out = tile_h * w * c_out * 4 + 2 * tile_h * w * c_out * dtype_bytes
    weights = c * c_out * dtype_bytes + 9 * c * 4
    return (blocks + acc + out + weights) < budget and h % tile_h == 0


def v3_vmem_ok(h: int, w: int, c: int, co: int, d: int, tile_h: int,
               budget: int = 23 * 1024 * 1024) -> bool:
    """The JAX package's admission formula of ``fused_sepconv_infer_v3``."""
    center = 2 * tile_h * w * c * 2
    halos = 4 * d * w * c * 2
    xt = (tile_h + 2 * d) * (w + 2 * d) * c * 2
    acc = tile_h * w * c * 4
    out = 2 * tile_h * w * co * 2 + tile_h * w * co * 4
    wts = c * co * 2 + 9 * c * 4 + 2 * (c + co) * 4
    return (center + halos + xt + acc + out + wts) < budget


def v3_skip_vmem_ok(h: int, w: int, c: int, cin: int, co: int, d: int,
                    stride: int, t_out: int,
                    budget: int = 23 * 1024 * 1024) -> bool:
    """The JAX package's admission formula of
    ``fused_sepconv_infer_v3_skip``."""
    t_in = stride * t_out
    center = 2 * t_in * w * c * 2
    halos = 4 * d * w * c * 2
    xin = 2 * t_in * w * cin * 2
    xt = (t_in + 2 * d) * (w + 2 * d) * c * 2
    acc = t_out * w * c * 4
    out = 2 * t_out * w * co * 2 + t_out * w * co * 4
    wts = c * co * 2 + cin * co * 2 + 9 * c * 4 + 4 * (c + co) * 4
    return (center + halos + xin + xt + acc + out + wts) < budget


# ------------------------------------------------------------ plain versions
def _sepconv_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                   dilation=1, pre_relu=False, int8_dot=False, stride=1, skip=None,
                   x_in=None, skip_kernel=None, skip_scale=None, skip_bias=None):
    """The function family in plain PyTorch, in the kernel's order."""
    c = x.shape[-1]
    y = x.permute(0, 3, 1, 2).float()
    if pre_relu:
        y = torch.relu(y)
    taps = dw_kernel.reshape(3, 3, c).float().permute(2, 0, 1).unsqueeze(1)
    y = F.conv2d(y, taps, stride=stride, padding=dilation, dilation=dilation, groups=c)
    y = y.permute(0, 2, 3, 1) * mid_scale.float() + mid_bias.float()
    pw = pw_kernel.reshape(c, -1)
    if int8_dot:
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
        out = int8_matmul(q.reshape(-1, c), pw)
    else:
        out = y.to(pw.dtype).float().reshape(-1, c) @ pw.float()
    out = out.reshape(*y.shape[:-1], -1) * out_scale.float() + out_bias.float()
    if skip == "conv":
        picked = x_in[:, ::stride, ::stride]
        skw = skip_kernel.reshape(x_in.shape[-1], -1).to(x.dtype)
        sk = picked.to(x.dtype).float().reshape(-1, x_in.shape[-1]) @ skw.float()
        out = out + sk.reshape(out.shape) * skip_scale.float() + skip_bias.float()
    elif skip == "sum":
        out = out + x_in.float()
    return out.to(x.dtype)


def fused_sepconv_infer_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale,
                              out_bias, dilation=1, pre_relu=False):
    """Plain PyTorch version of ``fused_sepconv_infer``."""
    return _sepconv_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                          dilation, pre_relu)


def fused_sepconv_infer_v2_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale,
                                 out_bias, dilation=1, pre_relu=False):
    """Plain PyTorch version of ``fused_sepconv_infer_v2``."""
    return _sepconv_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                          dilation, pre_relu)


def fused_sepconv_infer_v3_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale,
                                 out_bias, dilation=1, pre_relu=False, int8_dot=False):
    """Plain PyTorch version of ``fused_sepconv_infer_v3``."""
    return _sepconv_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                          dilation, pre_relu, int8_dot)


def fused_sepconv_infer_v3_skip_plain(x, x_in, dw_kernel, mid_scale, mid_bias, pw_kernel,
                                      out_scale, out_bias, skip_kernel=None, skip_scale=None,
                                      skip_bias=None, dilation=1, stride=1, pre_relu=False,
                                      int8_dot=False, skip="conv"):
    """Plain PyTorch version of ``fused_sepconv_infer_v3_skip``."""
    _check_skip(x, x_in, pw_kernel, stride, skip)
    return _sepconv_plain(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                          dilation, pre_relu, int8_dot, stride, skip, x_in, skip_kernel,
                          skip_scale, skip_bias)


def _check_skip(x, x_in, pw_kernel, stride, skip):
    if skip not in ("conv", "sum"):
        raise ValueError(f"skip must be 'conv' or 'sum', got {skip!r}")
    n, h, w, c = x.shape
    co = pw_kernel.reshape(c, -1).shape[1]
    if skip == "sum" and (stride != 1 or tuple(x_in.shape) != (n, h, w, co)):
        raise ValueError(f"skip='sum' needs stride 1 and x_in {(n, h, w, co)}, got stride "
                         f"{stride} and {tuple(x_in.shape)}")
    if skip == "conv" and tuple(x_in.shape[:3]) != (n, h, w):
        raise ValueError(f"skip='conv' needs x_in (N, H, W, Cin) = {(n, h, w)} + (Cin,), got "
                         f"{tuple(x_in.shape)}")


# ------------------------------------------------------------------ kernel
class PackedSepconv(NamedTuple):
    """A layer's weights in the kernel's layout (``csrc/sepconv.cu``)."""

    dwp: torch.Tensor            # (11, Cp) f32: nine taps, mid scale, mid bias
    pw: torch.Tensor             # bf16/int8 (Cop, Cp); f32 (Cp, Cop)
    osb: torch.Tensor            # (2, Cop) f32: out scale, out bias
    skw: Optional[torch.Tensor]  # conv skip weights in x's dtype, packed like pw
    ska: Optional[torch.Tensor]  # (2, Cop) f32: skip scale, skip bias
    c: int
    co: int
    cin: int
    int8_dot: bool


class WeightCache:
    """What ``build()`` derives from a module's weights, kept per ``tag``
    until one of ``tensors`` is replaced or changed in place (its storage
    or version counter moves). Folding and packing take dozens of small
    launches a layer, which a forward of ~60 layers cannot afford."""

    def __init__(self):
        self._slots = {}

    def get(self, tag, tensors, build):
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        slot = self._slots.get(tag)
        if slot is None or slot[0] != key:
            slot = self._slots[tag] = (key, build())
        return slot[1]


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pack_matrix(w, dtype, device, f32_layout: bool):
    """(K, N) weights -> zero-padded (Np, Kp) in ``dtype``, or (Kp, Np)
    for the f32 CUDA-core product."""
    k, n = w.shape
    kp, np_ = _round_up(k, _PAD_IN), _round_up(n, _PAD_OUT)
    w = w.to(device=device, dtype=dtype)
    if f32_layout:
        out = torch.zeros((kp, np_), dtype=dtype, device=device)
        out[:k, :n] = w
    else:
        out = torch.zeros((np_, kp), dtype=dtype, device=device)
        out[:n, :k] = w.t()
    return out


def _pack_rows(rows, width, device):
    out = torch.zeros((len(rows), width), dtype=torch.float32, device=device)
    for i, r in enumerate(rows):
        out[i, : r.numel()] = r.to(device).float().reshape(-1)
    return out


def pack_sepconv(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                 int8_dot: bool = False, skip_kernel=None, skip_scale=None,
                 skip_bias=None) -> PackedSepconv:
    """The kernel's weight buffers for input ``x`` (its dtype and
    device): channels zero-padded to the kernel's chunk sizes, the
    pointwise (and conv-skip) weights in the product's operand layout."""
    c = x.shape[-1]
    dev, dt = x.device, x.dtype
    pw = pw_kernel.reshape(c, -1)
    co = pw.shape[1]
    if int8_dot:
        if pw.dtype != torch.int8:
            raise TypeError(f"int8_dot needs int8 pointwise weights, got {pw.dtype}")
    elif pw.dtype != dt:
        raise TypeError(f"pointwise weights are {pw.dtype}, input is {dt}")
    cp, cop = _round_up(c, _PAD_IN), _round_up(co, _PAD_OUT)
    taps = dw_kernel.reshape(9, c)
    dwp = _pack_rows([*taps, mid_scale, mid_bias], cp, dev)
    f32 = dt == torch.float32
    pw_p = _pack_matrix(pw, torch.int8 if int8_dot else dt, dev, f32 and not int8_dot)
    osb = _pack_rows([out_scale, out_bias], cop, dev)
    skw = ska = None
    cin = 0
    if skip_kernel is not None:
        sk = skip_kernel.reshape(-1, co)
        cin = sk.shape[0]
        skw = _pack_matrix(sk, dt, dev, f32)
        ska = _pack_rows([skip_scale, skip_bias], cop, dev)
    return PackedSepconv(dwp, pw_p, osb, skw, ska, c, co, cin, bool(int8_dot))


def _lib():
    lib = library("sepconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sepconv_launch.argtypes = [p] * 8 + [i] * 12 + [p]
    lib.sepconv_launch.restype = i
    for fn in (lib.sepconv_pad_in, lib.sepconv_pad_out):
        fn.argtypes = [i]
        fn.restype = i
    if lib.sepconv_pad_in(1) != _PAD_IN or lib.sepconv_pad_out(1) != _PAD_OUT:
        raise RuntimeError("csrc/sepconv.cu pads channels otherwise than pack_sepconv")
    return lib


def _check_input(t, name, like=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous NHWC array, got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: storage is not 16-byte aligned")
    if like is not None and (t.dtype != like.dtype or t.device != like.device):
        raise ValueError(f"{name}: {t.dtype} on {t.device}, x is {like.dtype} on {like.device}")


def _launch(x, packed: PackedSepconv, dilation, pre_relu, stride=1, skip=None, x_in=None):
    """Check, allocate the output and launch ``sepconv_launch`` on
    PyTorch's current stream."""
    _check_input(x, "x")
    n, h, w, c = x.shape
    if c != packed.c:
        raise ValueError(f"packed weights are for {packed.c} channels, x has {c}")
    for t in (packed.dwp, packed.pw, packed.osb, packed.skw, packed.ska):
        if t is not None and t.device != x.device:
            raise ValueError(f"packed weights on {t.device}, x on {x.device}")
    want = torch.int8 if packed.int8_dot else x.dtype
    if packed.pw.dtype != want or (packed.skw is not None and packed.skw.dtype != x.dtype):
        raise TypeError(f"packed weights do not match x ({x.dtype}, int8_dot={packed.int8_dot})")
    if skip is not None:
        _check_input(x_in, "x_in", like=x)
    if skip == "conv" and (packed.skw is None or x_in.shape[-1] != packed.cin):
        raise ValueError("skip='conv': packed weights hold no skip kernel for this x_in")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((n, ho, wo, packed.co), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sepconv_launch(
            x.data_ptr(), x_in.data_ptr() if skip is not None else None, out.data_ptr(),
            packed.dwp.data_ptr(), packed.pw.data_ptr(), packed.osb.data_ptr(),
            packed.skw.data_ptr() if skip == "conv" else None,
            packed.ska.data_ptr() if skip == "conv" else None,
            n, h, w, c, packed.co, packed.cin if skip == "conv" else 0, int(dilation),
            int(stride), int(bool(pre_relu)), _SKIP_CODES[skip],
            int(x.dtype == torch.bfloat16), int(packed.int8_dot), stream,
        )
    if rc == -2:
        raise ValueError(f"sepconv kernel: dilation {dilation} at stride {stride} needs more "
                         "shared memory for its haloed tile than the card has")
    if rc != 0:
        raise RuntimeError(f"sepconv_launch: error {rc}")
    return out


def _run(wrapper, plain, x, weights, packed, int8_dot, **kw):
    """Shared body of the four entry points."""
    if x.device.type == "cpu":
        return plain()
    if packed is None:
        packed = pack_sepconv(x, *weights, int8_dot=int8_dot)
    out = _launch(x, packed, **kw)
    wrapper.launches += 1
    return out


def fused_sepconv_infer(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                        dilation: int = 1, pre_relu: bool = False, tile_h: int = 8,
                        interpret: bool = False, packed: Optional[PackedSepconv] = None):
    """x (N,H,W,C) -> (N,H,W,Co). ``dw_kernel`` (3,3,1,C) or (3,3,C);
    ``pw_kernel`` (C,Co) or (1,1,C,Co) in ``x.dtype``."""
    weights = (dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias)
    return _run(fused_sepconv_infer,
                lambda: fused_sepconv_infer_plain(x, *weights, dilation, pre_relu),
                x, weights, packed, False, dilation=dilation, pre_relu=pre_relu)


def fused_sepconv_infer_v2(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                           dilation: int = 1, pre_relu: bool = False, tile_h: int = 8,
                           interpret: bool = False, packed: Optional[PackedSepconv] = None):
    """Same function as :func:`fused_sepconv_infer` (the JAX package's
    pipelined variant; here the same kernel)."""
    weights = (dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias)
    return _run(fused_sepconv_infer_v2,
                lambda: fused_sepconv_infer_v2_plain(x, *weights, dilation, pre_relu),
                x, weights, packed, False, dilation=dilation, pre_relu=pre_relu)


def fused_sepconv_infer_v3(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
                           dilation: int = 1, pre_relu: bool = False, tile_h: int = 8,
                           int8_dot: bool = False, interpret: bool = False,
                           packed: Optional[PackedSepconv] = None):
    """:func:`fused_sepconv_infer` with the optional ``int8_dot``: the
    depthwise result is rounded to int8 inside the kernel and the
    pointwise product runs s8 x s8 -> s32 (arguments from
    :func:`fold_sepconv_int8`)."""
    weights = (dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias)
    return _run(fused_sepconv_infer_v3,
                lambda: fused_sepconv_infer_v3_plain(x, *weights, dilation, pre_relu, int8_dot),
                x, weights, packed, int8_dot, dilation=dilation, pre_relu=pre_relu)


def fused_sepconv_infer_v3_skip(x, x_in, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale,
                                out_bias, skip_kernel=None, skip_scale=None, skip_bias=None,
                                dilation: int = 1, stride: int = 1, pre_relu: bool = False,
                                tile_out: int = 8, int8_dot: bool = False, skip: str = "conv",
                                interpret: bool = False,
                                packed: Optional[PackedSepconv] = None):
    """Block-end fused sepconv: :func:`fused_sepconv_infer_v3` with the
    depthwise stride (1 or 2) and the XceptionBlock residual fused in:
    ``skip='conv'`` a 1x1 stride-``stride`` conv (+ folded BN) of the
    block input ``x_in`` (N,H,W,Cin); ``skip='sum'`` the identity add of
    ``x_in`` (stride 1). Output (N, H/stride, W/stride, Co)."""
    if x.device.type == "cpu":
        return fused_sepconv_infer_v3_skip_plain(
            x, x_in, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale, out_bias,
            skip_kernel, skip_scale, skip_bias, dilation, stride, pre_relu, int8_dot, skip)
    _check_skip(x, x_in, pw_kernel, stride, skip)
    if packed is None:
        conv = (skip_kernel, skip_scale, skip_bias) if skip == "conv" else ()
        packed = pack_sepconv(x, dw_kernel, mid_scale, mid_bias, pw_kernel, out_scale,
                              out_bias, int8_dot, *conv)
    out = _launch(x, packed, dilation, pre_relu, stride, skip, x_in)
    fused_sepconv_infer_v3_skip.launches += 1
    return out


for _fn in (fused_sepconv_infer, fused_sepconv_infer_v2, fused_sepconv_infer_v3,
            fused_sepconv_infer_v3_skip):
    _fn.launches = 0
