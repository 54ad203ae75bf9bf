"""The bf16 flash backward (``segmentron_tpu_torch/csrc/attention_bwd.cu``):
its arithmetic emulated in plain PyTorch on the CPU, and the tiles its
kernels pick, through their mirror ``ops/attention.py::bwd_plan``.

Arithmetic: q, k, v and do are bf16; s = q k^T and dp = do v^T are
products of bf16 operands summed in f32 (exact products, as in the tensor
cores); p and ds enter dv += p^T do, dk += ds^T q and dq += ds k as hi =
bf16(x) plus lo = bf16(x - hi), two products into one f32 sum; dq and dk
are scaled at the end and every result is cast to bf16 once. The summation
order differs from the card's.

At DANet's scale (1.0, Dk 64) and OCNet's (256^-0.5, Dk 256) the emulated
backward holds dq, dk and dv against float64 (cast to bf16, as the plain
version's results are) to the bar ``chip_smoke.py`` holds the kernels to:
max|err| <= 2 bf16 ulps of max|ref| and relative L2 error <= 4e-3; it
reaches ~0.02 of the L2 bar. Rounding p and ds to a single bf16 (the
FlashAttention-2 way) stays inside that bar too (~0.6-0.7 of it), so the
bar alone does not tell the two apart; before the cast to bf16 its f32
sums are ~30-60x further from float64 than the hi/lo pair's, which is what
the pair buys.
"""

import math

import numpy as np
import pytest
import torch

from segmentron_tpu_torch.ops.attention import _DV, bwd_plan

torch.set_num_threads(2)

CASES = {
    "DANet": dict(p=1024, dk=64, dv=128, scale=1.0),
    "OCNet": dict(p=1024, dk=256, dv=128, scale=256 ** -0.5),
}
SMEM_MAX = 232448  # an H100 block's dynamic shared memory


def bf16(x):
    return x.to(torch.bfloat16).float()


def inputs(p, dk, dv, scale, seed=0):
    """q, k, v, do as bf16 values (held in f32) and the forward's o (bf16)
    and lse (f32), from a float64 forward."""
    rng = np.random.default_rng(seed)
    q, k = (bf16(torch.from_numpy(rng.standard_normal((p, dk), dtype=np.float32)))
            for _ in range(2))
    v, do = (bf16(torch.from_numpy(rng.standard_normal((p, dv), dtype=np.float32)))
             for _ in range(2))
    s = (q.double() @ k.double().T) * scale
    o = torch.softmax(s, dim=-1) @ v.double()
    return q, k, v, do, bf16(o.float()), torch.logsumexp(s, dim=-1).float()


def backward(q, k, v, do, o, lse, scale, left):
    """dq, dk, dv before the cast: s and dp in f32 from bf16 operands, then
    the products with p or ds on the left through ``left(x)``, which gives
    the bf16 parts x is fed as (None: float64 throughout)."""
    delta = (do * o).sum(-1, keepdim=True)  # the wrapper's f32 delta
    if left is None:
        q, k, v, do, delta, lse = (t.double() for t in (q, k, v, do, delta, lse))
    p = torch.exp((q @ k.T) * scale - lse[:, None])
    ds = p * (do @ v.T - delta)

    def mm(a, b):
        return a @ b if left is None else sum(part @ b for part in left(a))

    return mm(ds, k) * scale, mm(ds.T, q) * scale, mm(p.T, do)


def hi_lo(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def single(x):
    return (bf16(x),)


def errors(case, left):
    """Per gradient: (max|err| / 2 bf16 ulps of max|ref|, relative L2 / 4e-3)
    after the cast to bf16, and the relative L2 error of the f32 sums."""
    q, k, v, do, o, lse = inputs(**case)
    got = backward(q, k, v, do, o, lse, case["scale"], left)
    ref = backward(q, k, v, do, o, lse, case["scale"], None)
    out = []
    for g, r in zip(got, ref):
        gb, rb = bf16(g).double(), bf16(r.float()).double()
        ulp = 2.0 ** (math.floor(math.log2(rb.abs().max().item())) - 7)
        out.append(((gb - rb).abs().max().item() / (2 * ulp),
                    ((gb - rb).norm() / rb.norm()).item() / 4e-3,
                    ((g.double() - r).norm() / r.norm()).item()))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_hi_lo_backward_within_the_card_bar(name):
    for gname, (max_share, l2_share, _) in zip(("dq", "dk", "dv"), errors(CASES[name], hi_lo)):
        assert max_share <= 1.0 and l2_share <= 0.1, (
            f"{name} {gname}: {max_share:.3g} of the max bar, {l2_share:.3g} of the L2 bar")


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_bf16_p_ds_is_far_from_float64_before_the_cast(name):
    pair, one = errors(CASES[name], hi_lo), errors(CASES[name], single)
    for gname, (_, _, e_pair), (_, l2_share, e_one) in zip(("dq", "dk", "dv"), pair, one):
        assert e_one >= 20 * e_pair, f"{name} {gname}: f32 sums {e_one:.3g} against {e_pair:.3g}"
        assert l2_share >= 0.3, f"{name} {gname}: single bf16 at {l2_share:.3g} of the L2 bar"


ADMITTED = [(dk, dv) for dk in range(16, 257, 16) for dv in _DV]


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_bwd_plan_fits_shared_memory(which):
    for dk, dv in ADMITTED:
        plan = bwd_plan(which, dk, dv)
        assert plan["smem"] <= SMEM_MAX, (which, dk, dv, plan)
        assert 2 <= plan["stages"] <= 4, (which, dk, dv, plan)
        if which == "dq":  # each warpgroup refills the stages it reads
            assert plan["stages"] % 2 == 0, (dk, dv, plan)
        else:  # one lane of the issuing warp copies lse and delta of each query
            assert plan["tile"] == 32, (dk, dv, plan)


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_bwd_plan_covers_every_p(which):
    plan = bwd_plan(which, 64, 512)
    for p in [*range(1, 700), 3698, 5184, 8192, 32768]:
        blocks = -(-p // plan["rows"])
        tiles = -(-p // plan["tile"])
        assert blocks * plan["rows"] >= p > (blocks - 1) * plan["rows"]
        assert tiles * plan["tile"] >= p > (tiles - 1) * plan["tile"]


@pytest.mark.parametrize("dk, dv", [(8, 128), (24, 128), (272, 128), (64, 64), (64, 384)])
def test_bwd_plan_rejects_what_the_wrapper_does_not_admit(dk, dv):
    for which in ("dq", "dkv"):
        with pytest.raises(ValueError):
            bwd_plan(which, dk, dv)
