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
  backward needs it). For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it computes ``flash_attention_plain``, the same
  function in plain PyTorch with the kernel's roundings (``p`` cast to
  ``v.dtype`` before the product; with ``block_k`` =
  ``fwd_plan(...)["tile"]`` it rounds ``p`` at the bf16 kernel's running
  max). ``flash_attention.launches`` counts kernel launches.
- ``flash_attention_bwd``: the backward, two hand-written CUDA kernels
  (``csrc/attention_bwd.cu``) that replace the Pallas kernels
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``
  (``_attention_pallas_bwd``): dq, then dk and dv, recomputed from the
  saved lse, never holding the affinity. ``delta = rowsum(do * o)`` is
  taken here in f32, as the JAX package takes it outside Pallas. For a
  CUDA tensor it launches both kernels or raises; for a CPU tensor it
  computes ``flash_attention_bwd_plain``. ``flash_attention_bwd_dq`` and
  ``flash_attention_bwd_dkv`` are the two launches, each with its count
  ``.launches``.
- ``FlashAttention``: the autograd function of the flash route (forward
  ``flash_attention``, backward ``flash_attention_bwd``), the counterpart
  of the custom VJP ``_attention_pallas_diff``.

On an H100 the kernels are bound by operations: at DANet's shape (P 32768,
Dk 64, Dv 512) the forward does 1.237 TFLOP, 1.25 ms at the bf16
tensor-core peak; the sources describe their designs and bounds. In bf16
the forward runs on ``wgmma`` over TMA rings of k and v, Dv 512 split
over the grid in two halves of 256 columns; ``fwd_plan`` mirrors its
tiles, stages and shared memory. In bf16 the backward runs on ``wgmma``
over a ring of TMA stages, p and ds fed as hi + lo bf16 pairs;
``bwd_plan`` mirrors the tiles, stages and shared memory its kernels
pick. In f32 the backward's five products run on the
tensor cores in split TF32 (each operand as a TF32 hi and lo, three
``mma.sync`` for each product, ~21 bits kept of each operand), not on the
CUDA cores' FMA; nothing on the route reads ``torch.backends``' TF32
switches.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import library

__all__ = [
    "FlashAttention",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "bwd_plan",
    "fwd_plan",
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


def flash_attention_bwd_plain(q, k, v, do, o, lse, scale: float, block_q: int = 512,
                              block_k: int = 512):
    """Plain PyTorch version of ``flash_attention_bwd``, the JAX
    package's math: ``delta = rowsum(do * o)``, then per (query block,
    key block) ``p = exp(scale q k^T - lse)``, ``dp = do v^T``,
    ``ds = p (dp - delta)``, ``dq += scale ds k``, ``dk += scale ds^T q``,
    ``dv += p^T do``; everything in f32 from inputs cast to f32, the
    results cast to q's, k's and v's dtypes at the end. It never holds
    more than ``block_q x block_k`` of the affinity per batch entry."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    lse = lse.float().unsqueeze(-1)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    p = q.shape[1]
    for i in range(0, p, block_q):
        qi, doi = qf[:, i:i + block_q], dof[:, i:i + block_q]
        for j in range(0, p, block_k):
            kj, vj = kf[:, j:j + block_k], vf[:, j:j + block_k]
            pij = torch.exp(torch.bmm(qi, kj.transpose(1, 2)) * scale - lse[:, i:i + block_q])
            ds = pij * (torch.bmm(doi, vj.transpose(1, 2)) - delta[:, i:i + block_q])
            dq[:, i:i + block_q] += torch.bmm(ds, kj) * scale
            dk[:, j:j + block_k] += torch.bmm(ds.transpose(1, 2), qi) * scale
            dv[:, j:j + block_k] += torch.bmm(pij.transpose(1, 2), doi)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = library("attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i,
                                           ctypes.c_float, i, ptr]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_plan.argtypes = [i, i, ctypes.POINTER(i)]
    lib.flash_attention_plan.restype = i
    return lib


def _lib_bwd():
    lib = library("attention_bwd")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_dq_launch.argtypes = [ptr] * 7 + [i, i, i, i, f, i, ptr]
    lib.flash_attention_bwd_dkv_launch.argtypes = [ptr] * 8 + [i, i, i, i, f, i, ptr]
    lib.flash_attention_bwd_dq_launch.restype = i
    lib.flash_attention_bwd_dkv_launch.restype = i
    lib.flash_attention_bwd_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.flash_attention_bwd_plan.restype = i
    return lib


_SMEM_MAX = 232448  # an H100 block's dynamic shared memory


def bwd_plan(which: str, dk: int, dv: int) -> dict:
    """The bf16 backward kernels' tiles for (Dk, Dv), as
    ``csrc/attention_bwd.cu`` picks them (``DqPlan``, ``DkvPlan``,
    ``flash_attention_bwd_plan``): ``rows`` a block keeps (queries for
    "dq", keys for "dkv"), ``tile`` rows a ring stage streams, ``stages``
    and the dynamic shared memory ``smem`` in bytes. Dk is padded to 64,
    128 or 256 columns; every tile is bf16, 2 bytes an element, with 1 KB
    of slack to align the swizzled tiles and 8 bytes an mbarrier. dk/dv:
    the resident k and v, per stage q, do, lse and delta, the warpgroups'
    partial s^T and dp^T (2 x 128 threads x 32 f32); up to 4 stages. dq:
    the resident q and do, the ring (at least warpgroup 1's dq sum, 128
    threads x DKP/2 f32, which ends over it); 4 stages or 2 (even)."""
    if which not in ("dq", "dkv") or dk % 16 or not 16 <= dk <= 256 or dv not in _DV:
        raise ValueError(f"bwd_plan: no plan for {which!r}, Dk {dk}, Dv {dv}")
    dkp = 64 if dk <= 64 else 128 if dk <= 128 else 256
    if which == "dkv":
        rows, tile = 64, 32

        def size(stages):
            return (1024 + 2 * rows * (dkp + dv) + stages * (2 * tile * (dkp + dv) + 2 * tile * 4)
                    + 2 * 128 * tile * 4 + (2 * stages + 1) * 8)

        stages = next(st for st in (4, 3, 2) if size(st) <= _SMEM_MAX or st == 2)
    else:
        rows, tile = 64, 32

        def size(stages):
            ring = max(stages * 2 * tile * (dkp + dv), 128 * (dkp // 2) * 4)
            return 1024 + 2 * rows * (dkp + dv) + ring + (stages + 1) * 8

        stages = 4 if size(4) <= _SMEM_MAX else 2
    return dict(rows=rows, tile=tile, stages=stages, smem=size(stages))


def fwd_plan(dk: int, dv: int) -> dict:
    """The bf16 forward kernel's tiles for (Dk, Dv), as
    ``csrc/attention.cu`` picks them (``FwdPlan``, ``flash_attention_plan``):
    ``rows`` of queries a block keeps (two warpgroups of 64), ``tile`` keys
    a ring slot streams, ``stages`` slots in each of the k and v rings,
    ``split`` the blocks Dv is split over (Dv 512: two halves of 256) and
    the dynamic shared memory ``smem`` in bytes: 1 KB of slack to align the
    swizzled tiles, q, the rings of k and of the block's v columns (bf16,
    Dk padded to 64, 128 or 256) and 8 bytes an mbarrier (a full and an
    empty one a slot of each ring, one for q); up to 4 slots that fit."""
    if dk % 16 or not 16 <= dk <= 256 or dv not in _DV:
        raise ValueError(f"fwd_plan: no plan for Dk {dk}, Dv {dv}")
    dkp = 64 if dk <= 64 else 128 if dk <= 128 else 256
    rows, tile, dvb = 128, 64, min(dv, 256)

    def size(stages):
        return 1024 + 2 * rows * dkp + stages * 2 * tile * (dkp + dvb) + (4 * stages + 1) * 8

    stages = next(st for st in (4, 3, 2) if size(st) <= _SMEM_MAX or st == 2)
    return dict(rows=rows, tile=tile, stages=stages, split=dv // dvb, smem=size(stages))


def _check(q, k, v, *more):
    """Raise for inputs the kernels do not take; ``more`` are further
    tensors of v's shape and dtype (the backward's do and o)."""
    if (not all(t.device == q.device for t in (k, v, *more))
            or q.device.type != "cuda"):
        raise ValueError(f"flash_attention: unsupported devices "
                         f"{[str(t.device) for t in (q, k, v, *more)]}")
    if any(t.shape != v.shape or t.dtype != v.dtype or not t.is_contiguous() for t in more):
        raise ValueError("flash_attention: do and o must be contiguous, of v's shape and dtype")
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


def _raise_rc(name, rc):
    if rc != 0:
        what = {-1: "unsupported shape or alignment",
                -2: "no TMA tensor map for these tensors"}.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{name}: {what}")


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
    _raise_rc("flash_attention_launch", rc)


def _launch_bwd(which, q, k, v, do, lse, delta, scale, *outs):
    """One launch of the backward kernel ``which`` ("dq": outs = (dq,);
    "dkv": outs = (dk, dv)); no checks, no count."""
    n, p, dk = q.shape
    name = f"flash_attention_bwd_{which}_launch"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_lib_bwd(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), n, p, dk, v.shape[-1],
            float(scale), int(q.dtype == torch.bfloat16), stream,
        )
    _raise_rc(name, rc)


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


def _bwd_stats(q, do, o, lse):
    """(lse, delta = rowsum(do * o)) as contiguous (N, P) f32."""
    if lse.shape != q.shape[:2]:
        raise ValueError(f"flash_attention_bwd: lse of shape {tuple(lse.shape)}")
    return lse.float().contiguous(), (do.float() * o.float()).sum(-1)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float):
    """dq (N, P, Dk) in q's dtype: the dq kernel, one launch (CUDA
    tensors that ``_check`` admits; lse, delta contiguous (N, P) f32)."""
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, do, lse, delta, scale, dq)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) in k's and v's dtype: the dk/dv kernel, one launch."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, do, lse, delta, scale, dk, dv)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, do, o, lse, scale: float):
    """q, k (N, P, Dk), v, do and the forward's out o (N, P, Dv), lse
    (N, P) f32 -> (dq, dk, dv) in q's, k's and v's dtypes."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, o, lse, scale)
    _check(q, k, v, do, o)
    lse, delta = _bwd_stats(q, do, o, lse)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


class FlashAttention(torch.autograd.Function):
    """The flash route with its gradient: forward ``flash_attention``
    (saving q, k, v, out and lse, as ``_attention_pallas_diff_fwd``
    does), backward ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(), out, lse, ctx.scale)
        return dq, dk, dv, None


def spatial_attention(q, k, v, scale: float = 1.0, use_pallas: bool = False,
                      min_seq_for_pallas: int = 2048):
    """q, k (N, P, Dk), v (N, P, Dv) -> (N, P, Dv) in ``v.dtype``. The
    JAX package's gate less its backend check: with ``use_pallas`` and
    P >= ``min_seq_for_pallas`` the flash route (the kernel on a CUDA
    tensor, its plain version on the CPU), else the dense one. Both are
    differentiable: the flash route through ``FlashAttention``."""
    if use_pallas and q.shape[1] >= min_seq_for_pallas:
        return FlashAttention.apply(q, k, v, float(scale))
    return _attention_dense(q, k, v, float(scale))
