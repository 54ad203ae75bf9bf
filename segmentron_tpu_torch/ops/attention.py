"""Spatial affinity attention (counterpart of ``segmentron_tpu/ops/attention.py``):
DANet's position attention and OCNet's object-context blocks attend over
the flattened positions of a feature map, ``out_i = sum_j softmax_j(scale *
q_i . k_j) v_j``. The layout is the JAX package's, ``(N, P, C)``.

- ``_attention_dense``: f32 energies, softmax, f32 product, cast to
  ``v.dtype``; materialises the (P x P) affinity.
- ``flash_attention``: the online-softmax forward as a hand-written CUDA
  kernel (``csrc/attention.cu``), which replaces the Pallas kernel
  ``_flash_kernel`` (``_attention_pallas``). It never holds the affinity
  and returns ``(out, lse)``, the log-sum-exp of each query row in f32 (the
  backward will need it). For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it computes ``flash_attention_plain``, the same
  function in plain PyTorch with the kernel's roundings (``p`` cast to
  ``v.dtype`` before the product). ``flash_attention.launches`` counts
  kernel launches.

On an H100 the kernel is bound by operations: at DANet's shape (P 32768,
Dk 64, Dv 512) 1.237 TFLOP, 1.25 ms at the bf16 tensor-core peak; its
design is described in the source.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import library

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "spatial_attention",
]

_NEG_INF = -1e30
_DV = (128, 256, 512)  # the value widths the kernel is built for


def _attention_dense(q, k, v, scale: float):
    energy = torch.bmm(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(energy * scale, dim=-1)
    return torch.bmm(attn, v.float()).to(v.dtype)


def flash_attention_plain(q, k, v, scale: float, block_k: int = 4096):
    """Plain PyTorch version of ``flash_attention``: the same online
    softmax over blocks of ``block_k`` keys (so it never holds P x P
    floats), f32 running max, sum and accumulator, ``p`` rounded to
    ``v.dtype`` before the product. Returns ``(out, lse)``."""
    n, p, _ = q.shape
    qf = q.float()
    m = torch.full((n, p, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, p, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, p, v.shape[-1]), dtype=torch.float32, device=q.device)
    for j in range(0, p, block_k):
        s = torch.bmm(qf, k[:, j:j + block_k].float().transpose(1, 2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.bmm(e.to(v.dtype).float(), v[:, j:j + block_k].float())
        m = m_new
    out = (acc / l).to(v.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return out, lse


def _lib():
    lib = library("attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i,
                                           ctypes.c_float, i, ptr]
    lib.flash_attention_launch.restype = i
    return lib


def _check(q, k, v):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported devices {q.device}, {k.device}, "
                         f"{v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q, k, v must share one dtype of float32 and "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"flash_attention: expected q, k (N, P, Dk) and v (N, P, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    dk, dv = q.shape[-1], v.shape[-1]
    if dk % 16 or not 16 <= dk <= 256 or dv not in _DV:
        raise ValueError(f"flash_attention: the kernel takes Dk a multiple of 16 up to 256 "
                         f"and Dv in {_DV}, got Dk {dk}, Dv {dv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")


def _launch(q, k, v, scale, out, lse):
    """One launch of the kernel into ``out`` and ``lse`` (no checks, no
    count)."""
    n, p, dk = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            n, p, dk, v.shape[-1], float(scale), int(q.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        what = "unsupported shape" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"flash_attention_launch: {what}")


def flash_attention(q, k, v, scale: float):
    """q, k (N, P, Dk), v (N, P, Dv) -> (out (N, P, Dv) in ``v.dtype``,
    lse (N, P) f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    n, p, _ = q.shape
    out = torch.empty((n, p, v.shape[-1]), dtype=v.dtype, device=v.device)
    lse = torch.empty((n, p), dtype=torch.float32, device=q.device)
    _launch(q, k, v, scale, out, lse)
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def spatial_attention(q, k, v, scale: float = 1.0, use_pallas: bool = False,
                      min_seq_for_pallas: int = 2048):
    """q, k (N, P, Dk), v (N, P, Dv) -> (N, P, Dv) in ``v.dtype``. The
    JAX package's gate less its backend check: with ``use_pallas`` and
    P >= ``min_seq_for_pallas`` the flash route (the kernel on a CUDA
    tensor, its plain version on the CPU), else the dense one."""
    if use_pallas and q.shape[1] >= min_seq_for_pallas:
        return flash_attention(q, k, v, float(scale))[0]
    return _attention_dense(q, k, v, float(scale))
