"""Fused Xception entry chain: the stem, and the stem plus block1, as
hand-written CUDA kernels (``csrc/entrychain.cu``).

Replaces the Pallas kernels of ``segmentron_tpu/ops/entrychain.py``:
``fused_stem`` (``_stem_kernel``) and ``fused_stem_block1``
(``_stem_block1_kernel``), with the same arguments: NHWC images and the
JAX layouts of the weights (conv ``HWIO``, depthwise ``(3,3,1,C)``,
pointwise ``(1,1,C,C')``) with BN already folded into f32 affines
``(a, b)`` (``ops/quant.py::bn_folded_affine``). Inference only.

- ``fused_stem``: conv1 3x3 s2 3->32 +BN+ReLU, conv2 3x3 s1 32->64
  +BN+ReLU: (N,H,W,3) -> (N,H/2,W/2,64).
- ``fused_stem_block1``: the stem, then block1 (three separable convs
  64->128->128->128, dw3x3 +BN then pw1x1 +BN, no ReLU, the last dw
  stride 2) plus the 1x1 s2 conv skip +BN on the conv2 output, summed:
  (N,H,W,3) -> (N,H/4,W/4,128).

Bound on one H100 at 1024x2048, per image: stem+block1 does ~27.3 G MAC
(~54.5 GFLOP) and moves ~46 MB in bf16, so it is bound by operations
(~55 us at the dense bf16 tensor-core peak); the stem does ~10.1 G MAC
and moves ~80 MB, so it is bound by bytes. The kernels' design (one
thread block per output tile, every stage in shared memory, halos
recomputed; in bf16 the convs on the tensor cores, the depthwise convs
on the CUDA cores; in f32 all on the CUDA cores) is described in the
source. It is far from those bounds: its stages run one after the other
within a tile, each short and latency-bound.

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes
the plain PyTorch version (``*_plain``, the same stages as ``F.conv2d``
calls with the same casts) only for a CPU tensor. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .kernels import library

__all__ = [
    "fused_stem",
    "fused_stem_plain",
    "stem_supported",
    "fused_stem_block1",
    "fused_stem_block1_plain",
    "pack_weights",
    "stem_block1_supported",
]

_B = 16  # the JAX kernels' W-block; kept so the gates below match theirs


def stem_supported(h: int, w: int, c: int, strip: int = 8) -> bool:
    """The JAX package's geometry gate for ``fused_stem``."""
    return (
        c == 3
        and h % 2 == 0
        and w % (2 * _B) == 0
        and strip % 2 == 0
        and (h // 2) % strip == 0
        and h // 2 >= 2 * strip
    )


def stem_block1_supported(h: int, w: int, c: int, strip: int = 4) -> bool:
    """The JAX package's geometry gate for ``fused_stem_block1``."""
    return (
        c == 3
        and h % 4 == 0
        and w % (4 * _B) == 0
        and strip % 4 == 0
        and (h // 4) % strip == 0
        and h // 4 >= 2 * strip
    )


# ------------------------------------------------------------ plain versions
def _conv(y, k, dt, stride, pad, groups=1):
    """f32 conv of ``y`` (f32 holding values of ``dt``) with the HWIO
    kernel ``k`` rounded to ``dt``: products exact, sums in f32."""
    w = k.to(dt).float().permute(3, 2, 0, 1)
    return F.conv2d(y, w, stride=stride, padding=pad, groups=groups)


def _affine(y, a, b, dt, relu=False):
    """f32 affine (and ReLU) of an f32 sum, rounded to ``dt`` and kept
    in f32 for the next stage."""
    y = y * a.float().view(1, -1, 1, 1) + b.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(dt).float()


def _stem_nchw(x, k1, a1, b1, k2, a2, b2):
    dt = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    y = _affine(_conv(y, k1, dt, 2, 1), a1, b1, dt, relu=True)
    return _affine(_conv(y, k2, dt, 1, 1), a2, b2, dt, relu=True)


def fused_stem_plain(x, k1, a1, b1, k2, a2, b2):
    """Plain PyTorch version of ``fused_stem``."""
    y = _stem_nchw(x, k1, a1, b1, k2, a2, b2)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def fused_stem_block1_plain(x, stem_p, sep_p, skip_p):
    """Plain PyTorch version of ``fused_stem_block1``: every stage
    rounded to the input dtype, sums in f32."""
    dt = x.dtype
    inp = _stem_nchw(x, *stem_p)
    y = inp
    for i, (dwk, ad, bd, pwk, ap, bp) in enumerate(sep_p):
        y = _affine(_conv(y, dwk, dt, 2 if i == 2 else 1, 1, groups=y.shape[1]),
                    ad, bd, dt)
        y = _affine(_conv(y, pwk, dt, 1, 0), ap, bp, dt)
    wsk, a_s, b_s = skip_p
    sk = _affine(_conv(inp, wsk, dt, 2, 0), a_s, b_s, dt)
    return (y + sk).to(dt).permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------------ kernels
def _lib():
    lib = library("entrychain")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.entry_stem, lib.entry_stem_block1):
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.entry_param_count.argtypes = [i]
    lib.entry_param_count.restype = i
    return lib


def pack_weights(x, stem_p, sep_p=(), skip_p=()):
    """The kernels' weight buffer for input ``x``: all weights as one f32
    buffer on ``x``'s device, in the order ``csrc/entrychain.cu`` reads
    them; conv weights rounded to ``x.dtype`` (the plain version's
    casts), affines f32. A caller that runs the same weights many times
    packs them once and passes ``packed=`` to the wrappers."""
    pieces = []
    for t, is_weight in _kernel_order(stem_p, sep_p, skip_p):
        t = t.to(x.device, x.dtype) if is_weight else t.to(x.device)
        pieces.append(t.float().reshape(-1))
    return torch.cat(pieces)


def _kernel_order(stem_p, sep_p, skip_p):
    """(tensor, is a conv weight) in the order the kernel reads them:
    every conv's weight followed by its affine ``a`` and ``b``."""
    groups = [stem_p[:3], stem_p[3:]]
    for p in sep_p:
        groups += [p[:3], p[3:]]
    if skip_p:
        groups.append(skip_p)
    return [(t, j == 0) for g in groups for j, t in enumerate(g)]


def _check(x, name, mult):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"{name}: expected (N, H, W, 3), got {tuple(x.shape)}")
    n, h, w, _ = x.shape
    if h % mult or w % mult:
        raise ValueError(f"{name}: H and W must be multiples of {mult}, got {h}x{w}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous NHWC")


def _launch(entry, block1, x, prm, out):
    if prm.device != x.device or prm.dtype != torch.float32:
        raise ValueError(f"packed weights: {prm.dtype} on {prm.device}, input on {x.device}")
    lib = _lib()
    want = lib.entry_param_count(int(block1))
    if prm.numel() != want:
        raise ValueError(f"packed parameters: {prm.numel()} floats, kernel reads {want}")
    n, h, w, _ = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), prm.data_ptr(), n, h, w,
            int(x.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def fused_stem(x, k1, a1, b1, k2, a2, b2, packed=None):
    """Fused stem: (N, H, W, 3) -> (N, H/2, W/2, 64). ``packed``: the
    ``pack_weights`` buffer of these weights for ``x``, or None."""
    if x.device.type == "cpu":
        return fused_stem_plain(x, k1, a1, b1, k2, a2, b2)
    _check(x, "fused_stem", 2)
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 2, w // 2, 64), dtype=x.dtype, device=x.device)
    if packed is None:
        packed = pack_weights(x, (k1, a1, b1, k2, a2, b2))
    _launch("entry_stem", False, x, packed, out)
    fused_stem.launches += 1
    return out


def fused_stem_block1(x, stem_p, sep_p, skip_p, packed=None):
    """Fused stem + block1: (N, H, W, 3) -> (N, H/4, W/4, 128).

    ``stem_p`` = (k1, a1, b1, k2, a2, b2); ``sep_p`` = three tuples
    (dw (3,3,1,C), a_dw, b_dw, pw (1,1,C,C'), a_pw, b_pw); ``skip_p`` =
    (wsk (1,1,64,128), a, b); ``packed``: their ``pack_weights`` buffer
    for ``x``, or None."""
    if x.device.type == "cpu":
        return fused_stem_block1_plain(x, stem_p, sep_p, skip_p)
    _check(x, "fused_stem_block1", 4)
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 4, w // 4, 128), dtype=x.dtype, device=x.device)
    if packed is None:
        packed = pack_weights(x, stem_p, sep_p, skip_p)
    _launch("entry_stem_block1", True, x, packed, out)
    fused_stem_block1.launches += 1
    return out


fused_stem.launches = 0
fused_stem_block1.launches = 0
