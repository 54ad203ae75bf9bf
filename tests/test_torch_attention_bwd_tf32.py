"""Split TF32, the arithmetic of the flash backward's f32 kernels
(``segmentron_tpu_torch/csrc/attention_bwd.cu``), emulated in plain
PyTorch on the CPU.

Each f32 operand x of the five products (s = q k^T, dp = do v^T, ds k,
ds^T q, p^T do) becomes hi = tf32(x) and lo = tf32(x - hi), rounded to
nearest with ties away from zero on the f32 bits (``cvt.rna.tf32.f32``),
and a b is taken as (a_lo b_hi + a_hi b_lo) + a_hi b_hi in f32, a_lo b_lo
dropped. The products of two tf32 values are exact in f32, as in the
tensor cores, so what is emulated here is the operands' rounding; the
summation order differs from the card's.

At DANet's scale (1.0, Dk 64) and OCNet's (256^-0.5, Dk 256) the emulated
backward holds dq, dk and dv against float64 to the bar ``chip_smoke.py``
holds the kernels to against their plain version, ``max|err| <= 1e-4
max(1, max|ref|)``, with about the error of plain f32 products: 0.073 of
the bar at DANet's scale (f32 products: 0.058), 0.006 at OCNet's (0.007).
One TF32 pass (no lo terms) misses the bar, 46 times over at DANet's
scale, which is why the kernels keep all three products for s as well.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BAR = 1e-4  # chip_smoke.py: f32 max|err| <= 1e-4 max(1, max|ref|)
CASES = {
    "DANet": dict(p=300, dk=64, dv=128, scale=1.0),
    "OCNet": dict(p=300, dk=256, dv=128, scale=256 ** -0.5),
}


def tf32_rna(x):
    """Round f32 to TF32 (10 mantissa bits), ties away from zero: add half
    of the dropped part's range to the bits, then clear it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_mm(a, b, passes=3):
    """a @ b in split TF32 (passes=3) or one TF32 pass (passes=1), f32."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def inputs(p, dk, dv, scale, seed=0):
    """q, k, v, do in f32 and the forward's o and lse (float64 forward,
    cast to f32, as the forward kernel hands them on)."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((p, dk), dtype=np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.standard_normal((p, dv), dtype=np.float32)) for _ in range(2))
    s = (q.double() @ k.double().T) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.softmax(s, dim=-1) @ v.double()
    return q, k, v, do, o.float(), lse.float()


def backward(q, k, v, do, o, lse, scale, mm):
    """dq, dk, dv with every product through ``mm``, the rest in the
    inputs' dtype (delta = rowsum(do o), as the wrapper computes it)."""
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp(mm(q, k.T) * scale - lse[:, None])
    ds = p * (mm(do, v.T) - delta)
    return mm(ds, k) * scale, mm(ds.T, q) * scale, mm(p.T, do)


def worst_share_of_bar(case, mm):
    q, k, v, do, o, lse = inputs(**case)
    got = backward(q, k, v, do, o, lse, case["scale"], mm)
    ref = backward(*(t.double() for t in (q, k, v, do, o, lse)), case["scale"],
                   lambda a, b: a @ b)
    return max((g.double() - r).abs().max().item() / (BAR * max(1.0, r.abs().max().item()))
               for g, r in zip(got, ref))


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_tf32_backward_within_the_f32_bar(name):
    share = worst_share_of_bar(CASES[name], split_mm)
    f32 = worst_share_of_bar(CASES[name], lambda a, b: a @ b)
    assert share <= 0.25, f"{name}: split TF32 reaches {share:.3g} of the bar"
    assert share <= 2 * f32, f"{name}: split TF32 {share:.3g} of the bar, f32 products {f32:.3g}"


def test_one_tf32_pass_misses_the_bar_at_danet_scale():
    share = worst_share_of_bar(CASES["DANet"], lambda a, b: split_mm(a, b, passes=1))
    assert share > 1.0, f"one TF32 pass reaches only {share:.3g} of the bar"
