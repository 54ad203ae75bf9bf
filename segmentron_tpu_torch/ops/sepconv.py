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
bf16 I/O at stride 1 (every v2 and v3 layer of the flagship's paths, and
the stride-1 block ends with their sum or conv skip) takes the ``wgmma``
kernel: input and weights by TMA, the taps of a K step on the CUDA cores
while the step before's products run on the tensor cores, persistent
blocks; x_in by TMA into the epilogue (sum) or as the A of a second
product (conv). Stride 2 and f32 I/O keep the first version's kernels:
the depthwise result of a block's 8 x 16 pixels resident in shared
memory where it fits, else recomputed per tile of 128 output channels. ``sepconv_plan``
says which kernel a call takes, and the source describes each design and
what keeps it from the bound.

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
    "sepconv_plan",
    "sepconv_vmem_ok",
    "v3_skip_vmem_ok",
    "v3_vmem_ok",
]

_PAD_IN, _PAD_OUT = 32, 128  # csrc/sepconv.cu: channel chunk, output-channel tile
_SKIP_CODES = {None: 0, "conv": 1, "sum": 2}
H100_SMS = 132
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may take on an H100
KERNELS = ("recompute", "resident", "wgmma")  # csrc/sepconv.cu's KernelId, in order


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


# ------------------------------------------------------------- the plan
def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _old_plan(n, h, w, c, co, d, stride, skip, itemsize, int8_dot, sms):
    """The older kernels' routes (``old_plan`` in the source): the resident kernel
    where the depthwise result of every channel fits in shared memory
    (tensor-core products), else the recompute kernel."""
    th, tw, kc, nt = 8, 16, 32, 128
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    ih, iw = (th - 1) * stride + 1 + 2 * d, (tw - 1) * stride + 1 + 2 * d
    cp, cop = _round_up(c, kc), _round_up(co, nt)
    tiles = _ceil(wo, tw) * _ceil(ho, th)
    if tiles > 65535 or n > 65535:
        return None, -1
    co_tiles = cop // nt
    a_item = 1 if int8_dot else itemsize  # the main product's operand
    # Tile<T>: A [128][ld], B [128][ld] (f32: B [32][128]); ld 40 | 48 | 36
    tile_ab = {2: (128 * 40 * 2, 128 * 40 * 2), 1: (128 * 48, 128 * 48),
               4: (128 * 36 * 4, 32 * 128 * 4)}
    stash = 64 * 256 * 4 if skip == "conv" else 0
    in_tile = _ceil(ih * iw * kc * itemsize, 16) * 16
    base = dict(tile=(th, tw), tiles=tiles, n=n)
    if not (itemsize == 4 and not int8_dot):
        step = 4 if a_item == 1 else 2
        stage = max(2 * in_tile, 2 * step * tile_ab[a_item][1], 64 * 136 * 4,
                    sum(tile_ab[itemsize]))
        smem = 128 * (cp + 16 // a_item) * a_item + stage + stash
        if smem <= MAX_SMEM and c % (16 // itemsize) == 0:
            split = min(max(sms // (tiles * n), 1), co_tiles)
            per = _ceil(co_tiles, split)
            return dict(base, kernel="resident", co_split=_ceil(co_tiles, per),
                        co_block=per * nt, smem=smem), 0
    smem = (max(tile_ab[a_item][0], tile_ab[itemsize][0])
            + max(tile_ab[a_item][1], tile_ab[itemsize][1]) + in_tile + stash)
    if smem > MAX_SMEM:
        return None, -2
    return dict(base, kernel="recompute", co_split=co_tiles, co_block=nt, smem=smem), 0


def sepconv_plan(n: int, h: int, w: int, c: int, co: int, d: int, stride: int = 1,
                 skip: Optional[str] = None, dtype=torch.bfloat16, int8_dot: bool = False,
                 sms: int = H100_SMS, cin: int = 0) -> dict:
    """The kernel ``sepconv_launch`` picks for these shapes, the mirror of
    ``sepconv_plan`` in ``csrc/sepconv.cu`` (``chip_smoke.py`` holds the two
    equal on the card): ``kernel`` ("wgmma", "resident" or "recompute"),
    ``tile`` (output rows, columns of a block, or of a wgmma item),
    ``grid`` (the older kernels: blocks over Co, pixel tiles, images; the
    wgmma kernel: persistent blocks, one an SM at most, walking the items
    (Co block, tile, image)), ``co_split`` (blocks or items a tile's output
    channels take), ``co_block`` (output channels of each), ``n_wg`` (the
    wgmma kernel's N a warpgroup), ``stages`` and ``in_stages`` (its
    weight-ring and input stages) and ``smem`` (dynamic shared memory,
    bytes). ``cin``: the conv skip's input channels. Raises ValueError
    where the source returns -1 or -2.

    The wgmma kernel takes bf16 I/O at stride 1, dilation 1 or 2 (the
    flagship's fused layers), without skip or with either skip, and C, Co
    and Cin multiples of 8, where two weight stages fit; everything else
    (stride 2, f32) keeps the older kernels' routes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {dtype}")
    if (min(n, h, w, c, co, d) < 1 or stride not in (1, 2) or skip not in _SKIP_CODES
            or (skip == "sum" and stride != 1) or (skip == "conv" and cin < 1)):
        raise ValueError("sepconv_plan: arguments no kernel takes")
    bf16 = dtype == torch.bfloat16
    cop = _round_up(co, _PAD_OUT)
    if (bf16 and stride == 1 and d in (1, 2) and c % 8 == 0 and co % 8 == 0
            and (skip != "conv" or cin % 8 == 0)):
        n_wg = 192 if cop % 384 == 0 else 128
        kc = 128 if int8_dot else 64
        # alignment slack, three A slots (the epilogue's staging too), two
        # slots of the affines (the conv skip's too), the barriers, a skip's
        # two x_in boxes and their barriers, two input stages (the haloed
        # box and the step's [11][kc] f32 depthwise weights); then as many
        # weight stages as fit (up to 4), and a third input stage if it fits
        in_bytes, stage = (8 + 2 * d) ** 2 * kc * 2 + 11 * kc * 4, 2 * n_wg * 128
        affines = (32 if skip == "conv" else 16) * n_wg
        x_in = 2 * 64 * 128 + 32 if skip else 0
        fixed = (1024 + 3 * 64 * 128 + 2 * affines + 8 * (2 * 3 + 4 + 2 * 4) + x_in
                 + 2 * in_bytes)
        stages = min((MAX_SMEM - fixed) // stage, 4)
        in_stages = 3 if MAX_SMEM - fixed - stages * stage >= in_bytes else 2
        co_split = _ceil(cop, 2 * n_wg)
        items = co_split * _ceil(h, 8) * _ceil(w, 8) * n
        if stages >= 2 and items < 2 ** 31:
            return dict(kernel="wgmma", tile=(8, 8), grid=(min(items, sms), 1, 1),
                        co_split=co_split, co_block=2 * n_wg, n_wg=n_wg, stages=stages,
                        in_stages=in_stages,
                        smem=fixed + stages * stage + (in_stages - 2) * in_bytes)
    got, rc = _old_plan(n, h, w, c, co, d, stride, skip, 2 if bf16 else 4, int8_dot, sms)
    if got is None:
        raise ValueError(f"sepconv_plan: no kernel takes these shapes (source's rc {rc})")
    return dict(kernel=got["kernel"], tile=got["tile"],
                grid=(got["co_split"], got["tiles"], got["n"]), co_split=got["co_split"],
                co_block=got["co_block"], n_wg=0, stages=0, in_stages=0, smem=got["smem"])


def kernel_plan(n, h, w, c, co, d, stride=1, skip=None, dtype=torch.bfloat16, int8_dot=False,
                cin=0, sms=0) -> dict:
    """``sepconv_plan`` as the compiled source reports it (needs ``nvcc``),
    in the mirror's form."""
    out = (ctypes.c_int * 12)()
    rc = _lib().sepconv_plan(n, h, w, c, co, cin if skip == "conv" else 0, d, stride, 1,
                             _SKIP_CODES[skip], int(dtype == torch.bfloat16), int(int8_dot),
                             sms, out)
    if rc != 0:
        raise ValueError(f"sepconv_plan: rc {rc}")
    v = list(out)
    return dict(kernel=KERNELS[v[0]], tile=(v[1], v[2]), grid=(v[3], v[4], v[5]),
                co_split=v[6], co_block=v[7], n_wg=v[8], stages=v[9], in_stages=v[10],
                smem=v[11])


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
    lib.sepconv_plan.argtypes = [i] * 13 + [p]
    lib.sepconv_plan.restype = i
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
    if rc == -3:
        raise RuntimeError("sepconv kernel: a TMA tensor map could not be made")
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
