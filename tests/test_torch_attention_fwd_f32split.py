"""The f32 flash forward (``segmentron_tpu_torch/csrc/attention.cu``: the
split pass ``split_planes_kernel``, then ``flash_f32_kernel``): its
arithmetic emulated in plain PyTorch on the CPU, the pieces of the split
pass, and the tiles the kernel picks, through their mirror
``ops/attention.py::fwd_plan(..., torch.float32)``.

Arithmetic: q and k become bf16 pieces hi = bf16(x), mid = bf16(x - hi),
lo = bf16(x - hi - mid), rounded to nearest even. s = q k^T is the sum of
six products of pieces, in the kernel's order lo.hi, hi.lo, mid.mid,
mid.hi, hi.mid, hi.hi (piece of q . piece of k), all into one f32
accumulator 16 columns of Dk a step (a ``wgmma`` k-step: exact products,
the sum rounded to f32 toward zero, as the tensor cores round; the card's
order inside a step differs); x = s * scale in f32, keys of a tile of
``fwd_plan(...)["tile"]``, the running max m, alpha = exp(m_old - m) and p
= exp(x - m) at the running max after each tile; l sums the f32 p; o = o
alpha, then o += p v key by key in order, one f32 FMA a term (the CUDA
cores); out = o / l, lse = m + log l.

Bars: the card holds the kernel to its plain version at max|err| <= 1e-4
max|ref|, lse <= 1e-4 max|lse|, and at 2.5e-5 max|ref|, lse 1e-5 max|lse|
(``chip_smoke.py``). The emulation is held to float64 at that margin, and
no further from it than 2 x the plain version in f32 (s and p v by
``bmm``: 3.2e-6 of max|ref| at DANet's scale, 1.05e-6 at OCNet's; the
kernel's sum key by key is the dense route's order, a little further from
float64 than ``bmm``'s blocked sums), lse within 1e-6 max|lse|. Cases:
DANet's scale (1.0, Dk 64, s up to ~40), OCNet's (256^-0.5, Dk 256), each
for 256 query rows over all keys, and a ragged one (P not a tile
multiple, Dk 48 padded to 64). Three products for s (hi.hi, hi.mid,
mid.hi) miss the margin at DANet's scale, which is why the lo pieces
stay.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.ops import attention as jax_attention
from segmentron_tpu_torch.ops.attention import (_DV, flash_attention_plain, fwd_plan,
                                                 split_pieces_plain)

torch.set_num_threads(2)

# rows: the query rows emulated (all keys each), to keep the file fast
CASES = {
    "DANet": dict(p=1024, dk=64, dv=512, scale=1.0, rows=256),
    "OCNet": dict(p=512, dk=256, dv=512, scale=256 ** -0.5, rows=256),
    "ragged": dict(p=600, dk=48, dv=256, scale=48 ** -0.5),
}
MARGIN = 2.5e-5  # a quarter of the card's f32 bar, 1e-4 max|ref|
LSE_BAR = 1e-5
F32_LSE_LEVEL = 1e-6
SMEM_MAX = 232448  # an H100 block's dynamic shared memory
S_KEYS = 256  # keys the emulation takes s for at once (a multiple of the tile)
# (piece of q, piece of k), 0 hi, 1 mid, 2 lo: the kernel's six products of
# s in its order, and three that keep only hi and mid
PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
S_THREE = ((1, 0), (0, 1), (0, 0))


def inputs(p, dk, dv, seed=0, rows=None, **_):
    """f32 q, k, v from a seeded numpy generator; ``rows``: the first of
    q's rows only."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((p, dk), dtype=np.float32)) for _ in range(2))
    return q[:rows], k, torch.from_numpy(rng.standard_normal((p, dv), dtype=np.float32))


def pieces(x, n):
    return [t.float() for t in split_pieces_plain(x, n)]


def toward_zero(x):
    """float64 -> f32, rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def k_steps(a, b, terms):
    """The products a[i] b[j]^T of the terms (i, j), 16 columns of the
    inner dimension a step, terms outer: (steps, rows of a, rows of b),
    each step's exact sum in float64."""
    a = torch.stack([a[i] for i, _ in terms]).double()
    b = torch.stack([b[j] for _, j in terms]).double()
    pad = -a.shape[-1] % 16  # keys past P: p = 0 and v = 0, as in the kernel
    a, b = (torch.nn.functional.pad(t, (0, pad)) for t in (a, b))
    n, ra, depth = a.shape
    a = a.view(n, ra, depth // 16, 16).transpose(1, 2)
    b = b.view(n, b.shape[1], depth // 16, 16).permute(0, 2, 3, 1)
    return (a @ b).reshape(n * (depth // 16), ra, -1)


def chain(acc, steps):
    """acc (None: the first step writes it) plus each step in turn, each
    sum rounded to f32 toward zero."""
    for step in steps:
        acc = toward_zero(step if acc is None else acc.double() + step)
    return acc


def emulate(q, k, v, scale, tile, s_terms=PRODUCTS):
    """(out f32, lse f32) of the kernel's arithmetic."""
    rows = q.shape[0]
    qp, kp = pieces(q, 3), pieces(k, 3)
    c = torch.tensor(scale, dtype=torch.float32)
    m = torch.full((rows, 1), -1e30)
    l = torch.zeros((rows, 1))
    o = torch.zeros((rows, v.shape[1]))
    vd = v.double()
    for j in range(0, k.shape[0], tile):
        if j % S_KEYS == 0:  # s of the next S_KEYS keys: each tile's, at once
            s_keys = chain(None, k_steps(qp, [t[j:j + S_KEYS] for t in kp], s_terms))
        x = s_keys[:, j % S_KEYS:j % S_KEYS + tile] * c
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(x - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        o = o * alpha
        ed = e.double()
        for i in range(x.shape[1]):  # key by key, one FMA (one rounding) a term
            o = (o.double() + ed[:, i:i + 1] * vd[j + i]).float()
        m = m_new
    return o / l, (m + torch.log(l)).squeeze(-1)


def float64_reference(q, k, v, scale):
    s = (q.double() @ k.double().T) * scale
    return torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1)


def shares(out, lse, ref, ref_lse):
    """(max|err| / max|ref|, lse max|err| / max|lse|)."""
    return ((out.double() - ref.double()).abs().max().item() / ref.abs().max().item(),
            (lse.double() - ref_lse.double()).abs().max().item() / ref_lse.abs().max().item())


@functools.lru_cache(maxsize=None)
def kernel_emulation(name, s_terms=PRODUCTS):
    case = CASES[name]
    q, k, v = inputs(**case)
    return emulate(q, k, v, case["scale"], fwd_plan(case["dk"], case["dv"], torch.float32)["tile"],
                   s_terms)


def distance(name, **kw):
    case = CASES[name]
    out, lse = kernel_emulation(name, **kw)
    return shares(out, lse, *float64_reference(*inputs(**case), case["scale"]))


@pytest.mark.parametrize("dist", ["normal", "wide exponents"])
def test_pieces_reconstruct_x(dist):
    """hi + mid + lo gives x within 2^-24 |x| (exactly, for these normal
    floats), each piece a bf16 value, each below the one before by 2^-8 or
    more."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).astype(np.float32)
    if dist == "wide exponents":
        x *= np.exp2(rng.integers(-100, 100, x.size)).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = split_pieces_plain(x, 3)
    assert hi.dtype == torch.bfloat16
    whole = hi.double() + mid.double() + lo.double()
    assert ((whole - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    assert (mid.double().abs() <= 2.0 ** -8 * hi.double().abs()).all()
    assert (lo.double().abs() <= 2.0 ** -8 * mid.double().abs()).all()
    assert torch.equal(split_pieces_plain(x, 2), torch.stack([hi, mid]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_within_the_margin_of_float64(name):
    got = distance(name)
    assert got[0] <= MARGIN and got[1] <= LSE_BAR, (name, got)


def plain_distance(name):
    """``flash_attention_plain``'s distance from float64 in f32 over the
    kernel's tile: sums rounded to nearest."""
    case = CASES[name]
    q, k, v = inputs(**dict(case, rows=None))
    plain, plain_lse = flash_attention_plain(q[None], k[None], v[None], case["scale"],
                                             block_k=fwd_plan(case["dk"], case["dv"],
                                                              torch.float32)["tile"])
    rows = slice(case.get("rows"))
    return shares(plain[0, rows], plain_lse[0, rows],
                  *float64_reference(*inputs(**case), case["scale"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_as_close_to_float64_as_f32(name):
    """No further from float64 than 2 x the plain version in f32 (the
    same function with sums rounded to nearest), lse within 1e-6."""
    got, plain = distance(name), plain_distance(name)
    assert got[0] <= 2 * plain[0] and got[1] <= F32_LSE_LEVEL, (name, got, plain)


def test_three_s_products_miss_the_margin_at_danet_scale():
    got = distance("DANet", s_terms=S_THREE)
    assert got[0] > MARGIN, got


@pytest.mark.parametrize("name", ["DANet", "ragged"])
def test_plain_version_within_the_margin_of_the_emulation(name):
    """``flash_attention_plain`` in f32, what the card holds the kernel to,
    and the emulation agree within the margin."""
    case = CASES[name]
    q, k, v = inputs(**dict(case, rows=None))
    plain, plain_lse = flash_attention_plain(q[None], k[None], v[None], case["scale"],
                                             block_k=fwd_plan(case["dk"], case["dv"],
                                                              torch.float32)["tile"])
    out, lse = kernel_emulation(name)
    rows = slice(case.get("rows"))
    got = shares(out, lse, plain[0, rows], plain_lse[0, rows])
    assert got[0] <= MARGIN and got[1] <= LSE_BAR, got


def test_emulation_matches_pallas_interpret():
    """The JAX package's ``_attention_pallas`` in f32 (interpret mode) on
    the ragged case's inputs, within the margin."""
    case = CASES["ragged"]
    q, k, v = (jnp.asarray(t.numpy()[None]) for t in inputs(**case))
    want, want_lse = jax_attention._attention_pallas(q, k, v, scale=case["scale"], block_q=512,
                                                     block_k=512, interpret=True)
    out, lse = kernel_emulation("ragged")
    got = shares(out, lse, torch.from_numpy(np.array(want)[0]),
                 torch.from_numpy(np.array(want_lse)[0]))
    assert got[0] <= MARGIN and got[1] <= LSE_BAR, got


ADMITTED = [(dk, dv) for dk in range(16, 257, 16) for dv in _DV]


def test_f32_plan_fits_shared_memory():
    for dk, dv in ADMITTED:
        plan = fwd_plan(dk, dv, torch.float32)
        assert plan["smem"] <= SMEM_MAX, (dk, dv, plan)
        # 64 query rows (one consumer warpgroup) only where 128 rows of q's
        # three pieces would not leave room for the rings
        assert plan["rows"] == (64 if dk > 128 else 128), (dk, dv, plan)
        assert plan["tile"] == 32, (dk, dv, plan)
        assert 1 <= plan["stages"] <= 2 and 2 <= plan["v_stages"] <= 8, (dk, dv, plan)
        assert plan["split"] == (2 if dv == 512 and dk <= 128 else 1), (dk, dv, plan)
    # the serving shapes: DANet (Dk 64) and OCNet (Dk 256) at Dv 512
    assert fwd_plan(64, 512, torch.float32)["v_stages"] == 8
    assert fwd_plan(256, 512, torch.float32)["stages"] == 1


def test_f32_plan_rejects_what_the_wrapper_does_not_admit():
    for dk, dv in [(8, 128), (24, 128), (272, 128), (64, 64), (64, 384)]:
        with pytest.raises(ValueError):
            fwd_plan(dk, dv, torch.float32)
    with pytest.raises(ValueError):
        fwd_plan(64, 128, torch.float16)
