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

Two routes in the one source, picked on the host from the shapes: the
``wgmma`` route (every shape but int8 with K > 768), a persistent grid of
128 x 192 tiles fed by a TMA or a cp.async producer warpgroup, and the
kernel's first, ``mma.sync`` version for int8 deeper than the resident
stripe of w holds.
``plan`` is that choice of route, producer, tiles and grid, the mirror of
``probe_dot_plan`` in the source (``chip_smoke.py`` holds the two equal on
the card; ``kernel_plan`` asks the source); ``block_tiles`` the output
tiles a block walks.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import library

__all__ = ["block_tiles", "kernel_plan", "plan", "probe_dot", "probe_dot_plain"]

_DTYPES = (torch.int8, torch.bfloat16)
WGMMA_TILE = (128, 192)   # (BM, BN) of the wgmma route
MMA_SYNC_TILE = (128, 128)
MAX_S8_DEPTH = 768        # int8 K the resident stripe of w holds
H100_SMS = 132


def _copy_width(addr, row_bytes):
    """The widest cp.async (16, 8 or 4 bytes) dividing a row's bytes and
    the base address, else 1 (byte by byte)."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and addr % v == 0:
            return v
    return 1


def plan(m, k, n, int8, x_addr=0, w_addr=0, sms=H100_SMS):
    """The launch's route for x (m, k) and w (k, n) at these base
    addresses, as ``probe_dot_plan`` picks it: ``route`` "wgmma" (every
    shape but int8 with K > 768, whose transposed stripe of w would not
    fit beside the ring) or "mma.sync"; ``producer`` "tma" where x's rows
    (and bf16 w's) are multiples of 16 bytes on 16-byte aligned bases,
    else "cp.async"; the tile, the column and row tile counts, ``per``
    blocks a column stripe (the wgmma grid is persistent: at most one
    block an SM) and the grid; ``vec_a``/``vec_b`` the cp.async widths."""
    es = 1 if int8 else 2
    wgmma = not int8 or k <= MAX_S8_DEPTH
    vec_a, vec_b = _copy_width(x_addr, k * es), _copy_width(w_addr, n * es)
    bm, bn = WGMMA_TILE if wgmma else MMA_SYNC_TILE
    n_tiles, m_tiles = -(-n // bn), -(-m // bm)
    tma = wgmma and vec_a == 16 and (int8 or vec_b == 16)
    per = min(max(sms // n_tiles, 1), m_tiles) if wgmma else 1
    return dict(route="wgmma" if wgmma else "mma.sync",
                producer="tma" if tma else "cp.async",
                tile=(bm, bn), n_tiles=n_tiles, m_tiles=m_tiles, per=per,
                grid=n_tiles * per if wgmma else n_tiles * m_tiles, vec_a=vec_a, vec_b=vec_b)


def block_tiles(p, block):
    """(row, column) origins of the output tiles block ``block`` of plan
    ``p`` computes: the wgmma route's block j of column stripe s walks row
    tiles j, j + per, ...; the mma.sync route's block owns one tile."""
    bm, bn = p["tile"]
    if p["route"] == "mma.sync":
        return [(block // p["n_tiles"] * bm, block % p["n_tiles"] * bn)]
    stripe, first = divmod(block, p["per"])
    return [(t * bm, stripe * bn) for t in range(first, p["m_tiles"], p["per"])]


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
    lib.probe_dot_plan.argtypes = [ptr, ptr, i, i, i, i, i, ptr]
    lib.probe_dot_plan.restype = i
    return lib


def kernel_plan(x, w):
    """The source's own ``probe_dot_plan`` for these operands on the
    current device, in ``plan``'s keys (loads the library)."""
    (m, k), n = x.shape, w.shape[1]
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(x.device):
        rc = _lib().probe_dot_plan(x.data_ptr(), w.data_ptr(), m, n, k,
                                   int(x.dtype == torch.int8), 0, out)
    if rc != 0:
        raise RuntimeError("probe_dot_plan: unsupported shape")
    route, tma, n_tiles, m_tiles, per, grid, vec_a, vec_b = out
    return dict(route="wgmma" if route else "mma.sync", producer="tma" if tma else "cp.async",
                n_tiles=n_tiles, m_tiles=m_tiles, per=per, grid=grid, vec_a=vec_a, vec_b=vec_b)


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
