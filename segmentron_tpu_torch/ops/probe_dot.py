"""The ceiling probe's pointwise-shape matrix product as a hand-written
CUDA kernel (``csrc/probe_dot.cu``), which replaces the Pallas kernel
``kern`` of ``tools/ceiling_probe.py`` (``pallas_dot``).

``probe_dot(x, w)``: x (M, K) and w (K, N), both int8 or both bf16 ->
out (M, N) of the same type.

- int8: the s8 x s8 -> s32 product, an arithmetic shift right by 7, and a
  cast to int8 that wraps (the low byte), as ``(acc >> 7).astype(int8)``
  does in the Pallas kernel: no saturation.
- bf16: the product accumulated in f32, rounded once to bf16 (nearest
  even).

For a CUDA tensor the wrapper launches the kernel on the current stream or
raises; for a CPU tensor it computes ``probe_dot_plain``.
``probe_dot.launches`` counts kernel launches. At the probe's shape,
(8192, 728) x (728, 728), the kernel is bound by operations on an H100:
4.39 us in int8, 8.78 us in bf16 at the dense tensor-core peaks.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import library

__all__ = ["probe_dot", "probe_dot_plain"]

_DTYPES = (torch.int8, torch.bfloat16)


def probe_dot_plain(x, w):
    """Plain PyTorch version of ``probe_dot``. int8: the product in
    float64, exact while |acc| < 2**53 (127 * 128 * K is far below),
    then ``>> 7`` on int64 (floor division by 128) and the low byte as
    int8. bf16: an f32 product (on a card, as precise as
    ``torch.backends.cuda.matmul.allow_tf32`` allows: set it False), then
    one round-to-nearest-even cast."""
    if x.dtype == torch.int8:
        acc = (x.double() @ w.double()).to(torch.int64) >> 7
        return ((acc + 128) % 256 - 128).to(torch.int8)
    return (x.float() @ w.float()).to(torch.bfloat16)


def _lib():
    lib = library("probe_dot")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_dot_launch.argtypes = [ptr, ptr, ptr, i, i, i, i, ptr]
    lib.probe_dot_launch.restype = i
    return lib


def _check(x, w):
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"probe_dot: unsupported devices {x.device}, {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"probe_dot: x and w must both be int8 or both bfloat16, got "
                        f"{x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"probe_dot: expected x (M, K) and w (K, N), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("probe_dot: x and w must be contiguous")


def _launch(x, w, out):
    """One launch of the kernel into ``out`` (no checks, no count)."""
    (m, k), n = x.shape, w.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().probe_dot_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                     int(x.dtype == torch.int8), stream)
    if rc != 0:
        what = "unsupported shape" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"probe_dot_launch: {what}")


def probe_dot(x, w):
    """x (M, K), w (K, N), both int8 or both bf16 -> (M, N) of their type."""
    if x.device.type == "cpu":
        return probe_dot_plain(x, w)
    _check(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    _launch(x, w, out)
    probe_dot.launches += 1
    return out


probe_dot.launches = 0
