"""The bf16 flash forward (``segmentron_tpu_torch/csrc/attention.cu``): its
arithmetic emulated in plain PyTorch on the CPU, and the tiles it picks,
through their mirror ``ops/attention.py::fwd_plan``.

Arithmetic: q, k and v are bf16; s = q k^T is a product of bf16 operands
summed in f32 (exact products, as in the tensor cores), scaled by
scale * log2(e) in f32; the running max m (log2 units), alpha = 2^(m_old -
m) and p = 2^(s - m) at the running max after each key tile of
``fwd_plan(...)["tile"]`` keys; l sums the f32 p; p is rounded to bf16
before p v; O = O alpha + P v with the product in f32, the rescale of a
tile done before the next tile's product is added (the kernel's order);
out = O / l cast to bf16 once, lse = m ln 2 + log l. Dv 512 is computed as
two blocks of 256 columns, each recomputing s. The summation order
differs from the card's.

Bars: against float64 (out cast to bf16, as the plain version's results
are), the ones ``chip_smoke.py`` holds the kernel to against its plain
version: max|err| <= 3e-2 max|ref|, mean|err| <= 2e-3 mean|ref|, lse
max|err| <= 1e-4 max|lse|. The exp2 form with log2(e) folded into the
scale stays inside them (the kernel runs ex2.approx, one instruction a
score). Against ``_attention_pallas(..., block_k=tile, interpret=True)`` on
the same bf16 inputs, which rounds p at the same running maxima with exp
in f32: out within 2 bf16 ulps of max|ref| at any element and 1e-3
mean|ref| on average (a p near a rounding boundary may round the other
way), lse within 1e-5 max|lse|.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.ops import attention as jax_attention
from segmentron_tpu_torch.ops.attention import _DV, flash_attention_plain, fwd_plan

torch.set_num_threads(2)

# DANet's PAM (scale 1, Dk 64) and OCNet's base block (scale 256^-0.5, Dk
# 256) at Dv 512, the kernel's split width; a ragged P (not a tile multiple).
CASES = {
    "DANet": dict(p=1024, dk=64, dv=512, scale=1.0),
    "OCNet": dict(p=512, dk=256, dv=512, scale=256 ** -0.5),
    "ragged": dict(p=600, dk=64, dv=512, scale=1.0),
}
SMEM_MAX = 232448  # an H100 block's dynamic shared memory
LOG2E = 1.4426950408889634


def bf16(x):
    return x.to(torch.bfloat16).float()


def inputs(p, dk, dv, seed=0, **_):
    """q, k, v as bf16 values held in f32, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    q, k = (bf16(torch.from_numpy(rng.standard_normal((p, dk), dtype=np.float32)))
            for _ in range(2))
    return q, k, bf16(torch.from_numpy(rng.standard_normal((p, dv), dtype=np.float32)))


def f32_product(a, b):
    """a b of bf16-valued f32 operands: exact products, summed and rounded
    to f32 (the same f32 for every column, whatever the others)."""
    return (a.double() @ b.double()).float()


def emulate(q, k, v, scale, tile, split, exp2=True):
    """(out as bf16 values in f32, lse f32) of the kernel's arithmetic, Dv
    computed as ``split`` blocks; ``exp2=False`` takes exp in natural units."""
    p, dv = q.shape[0], v.shape[1]
    c = torch.tensor(scale * LOG2E if exp2 else scale, dtype=torch.float32)
    expf = torch.exp2 if exp2 else torch.exp
    outs = []
    for h in range(split):
        vh = v[:, h * dv // split:(h + 1) * dv // split]
        m = torch.full((p, 1), -1e30)
        l = torch.zeros((p, 1))
        o = torch.zeros((p, vh.shape[1]))
        for j in range(0, p, tile):
            x = f32_product(q, k[j:j + tile].T) * c  # keys past P: not in the tile
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = expf(m - m_new)
            e = expf(x - m_new)
            l = l * alpha + e.sum(-1, keepdim=True)
            o = o * alpha + f32_product(bf16(e), vh[j:j + tile])
            m = m_new
        outs.append(bf16(o / l))
        lse = (m * math.log(2) if exp2 else m) + torch.log(l)
    return torch.cat(outs, 1), lse.squeeze(-1)


def float64_reference(q, k, v, scale):
    s = (q.double() @ k.double().T) * scale
    return bf16((torch.softmax(s, -1) @ v.double()).float()), torch.logsumexp(s, -1).float()


def bar_shares(out, lse, ref, ref_lse):
    """(max|err| / (3e-2 max|ref|), mean|err| / (2e-3 mean|ref|),
    lse max|err| / (1e-4 max|lse|)): each <= 1 passes the card's bar."""
    err = (out - ref).abs()
    return (err.max().item() / (3e-2 * ref.abs().max().item()),
            err.mean().item() / (2e-3 * ref.abs().mean().item()),
            (lse - ref_lse).abs().max().item() / (1e-4 * ref_lse.abs().max().item()))


def kernel_emulation(name, **kw):
    case = CASES[name]
    plan = fwd_plan(case["dk"], case["dv"])
    q, k, v = inputs(**case)
    return (q, k, v), emulate(q, k, v, case["scale"], plan["tile"], plan["split"], **kw)


@pytest.fixture(scope="module")
def pallas():
    """``_attention_pallas`` in interpret mode on each case's bf16 inputs,
    key blocks of the kernel's tile: {case: (out, lse)} as f32 tensors."""
    got = {}
    for name, case in CASES.items():
        q, k, v = (jnp.asarray(t.numpy()[None]).astype(jnp.bfloat16) for t in inputs(**case))
        out, lse = jax_attention._attention_pallas(
            q, k, v, scale=case["scale"], block_q=512,
            block_k=fwd_plan(case["dk"], case["dv"])["tile"], interpret=True)
        got[name] = (torch.from_numpy(np.array(out.astype(jnp.float32))[0]),
                     torch.from_numpy(np.array(lse)[0]))
    return got


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("exp2", [True, False], ids=["exp2", "exp"])
def test_emulation_within_the_card_bar_of_float64(name, exp2):
    (q, k, v), (out, lse) = kernel_emulation(name, exp2=exp2)
    shares = bar_shares(out, lse, *float64_reference(q, k, v, CASES[name]["scale"]))
    assert all(x <= 1.0 for x in shares), f"{name}: {shares} of the max, mean and lse bars"


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_pallas_interpret(name, pallas):
    _, (out, lse) = kernel_emulation(name)
    want, want_lse = pallas[name]
    err = (out - want).abs()
    max_ref = want.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(max_ref)) - 7)
    assert err.max().item() <= 2 * ulp, (name, err.max().item(), ulp)
    assert err.mean().item() <= 1e-3 * want.abs().mean().item(), (name, err.mean().item())
    assert (lse - want_lse).abs().max().item() <= 1e-5 * want_lse.abs().max().item()


@pytest.mark.parametrize("name", sorted(CASES))
def test_dv_split_equals_unsplit_bitwise(name):
    """Each Dv block recomputes s, m and l with the same arithmetic, so the
    two halves of Dv 512 are the columns of one unsplit pass, bit for bit."""
    case = CASES[name]
    tile = fwd_plan(case["dk"], case["dv"])["tile"]
    q, k, v = inputs(**case)
    split_out, split_lse = emulate(q, k, v, case["scale"], tile, 2)
    whole_out, whole_lse = emulate(q, k, v, case["scale"], tile, 1)
    assert torch.equal(split_out, whole_out) and torch.equal(split_lse, whole_lse)


def test_plain_version_at_the_plan_tile_matches_the_emulation():
    """``flash_attention_plain`` in bf16 over key blocks of the plan's tile
    (what the card holds the kernel to) rounds p at the same maxima: out
    within 2 bf16 ulps of max|ref|, lse within 1e-5 max|lse|."""
    case = CASES["ragged"]
    (q, k, v), (out, lse) = kernel_emulation("ragged")
    tq, tk, tv = (t.bfloat16()[None] for t in (q, k, v))
    plain, plain_lse = flash_attention_plain(tq, tk, tv, case["scale"],
                                             block_k=fwd_plan(case["dk"], case["dv"])["tile"])
    plain, plain_lse = plain[0].float(), plain_lse[0]
    ulp = 2.0 ** (math.floor(math.log2(plain.abs().max().item())) - 7)
    assert (out - plain).abs().max().item() <= 2 * ulp
    assert (lse - plain_lse).abs().max().item() <= 1e-5 * plain_lse.abs().max().item()


ADMITTED = [(dk, dv) for dk in range(16, 257, 16) for dv in _DV]


def test_fwd_plan_fits_shared_memory():
    for dk, dv in ADMITTED:
        plan = fwd_plan(dk, dv)
        assert plan["smem"] <= SMEM_MAX, (dk, dv, plan)
        assert 2 <= plan["stages"] <= 4, (dk, dv, plan)
        assert plan["rows"] == 128 and plan["tile"] == 64, (dk, dv, plan)
        # Dv 512 in two blocks of 256 columns: 128 f32 accumulators a thread
        assert plan["split"] == (2 if dv == 512 else 1), (dk, dv, plan)


def test_fwd_plan_rejects_what_the_wrapper_does_not_admit():
    for dk, dv in [(8, 128), (24, 128), (272, 128), (64, 64), (64, 384)]:
        with pytest.raises(ValueError):
            fwd_plan(dk, dv)
