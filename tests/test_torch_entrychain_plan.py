"""The bf16 entry kernel's plan, operand packing and index arithmetic
(segmentron_tpu_torch/ops/entrychain.py, csrc/entrychain.cu's
stem_block1_wgmma_kernel), on the CPU.

The kernel runs only on the card. These tests hold what surrounds it:
``entry_plan`` (the mirror chip_smoke.py holds to the source's), the bf16
B operands of ``pack_operands`` against an independent un-swizzle, and a
tile-by-tile emulation of the kernel's chain in f32 that walks its stages
as the source does: the same extents and origins, the same M tiles and
rows (conv2 over a raster as wide as c1, the skip at stride 2), and every
stage written into one shared stage area at the plan's offsets. sep1's and
sep2's chunks run in an order the kernel's barriers allow in which each
chunk's rows land before the taps of every chunk those barriers do not
order before them. Pixels the kernel never writes start as NaN, so a wrong
halo, a missing zero at an image edge or a stage overwritten while still
read moves whole pixels.
"""

import numpy as np
import pytest
import torch

from segmentron_tpu_torch.ops import entrychain as ec

torch.set_num_threads(2)

# (2, 768, 768): the Trainer's validation at the flagship's 768 crop, batch 2
SHAPES = [(1, 1024, 2048), (2, 48, 64), (1, 32, 128), (1, 1040, 2048), (2, 768, 768)]


def _params(seed):
    rng = np.random.RandomState(seed)

    def t(*s, scale=1.0, pos=False):
        v = rng.rand(*s) + 0.5 if pos else rng.randn(*s) * scale
        return torch.from_numpy(v.astype(np.float32))

    def sep(cin, cout):
        return (t(3, 3, 1, cin, scale=0.2), t(cin, pos=True), t(cin, scale=0.3),
                t(1, 1, cin, cout, scale=0.1), t(cout, pos=True), t(cout, scale=0.3))

    stem = (t(3, 3, 3, 32, scale=0.2), t(32, pos=True), t(32, scale=0.3),
            t(3, 3, 32, 64, scale=0.1), t(64, pos=True), t(64, scale=0.3))
    return stem, (sep(64, 128), sep(128, 128), sep(128, 128)), (
        t(1, 1, 64, 128, scale=0.1), t(128, pos=True), t(128, scale=0.3))


# ---------------------------------------------------------------------- plan
@pytest.mark.parametrize("n,h,w", SHAPES)
def test_plan_covers_output_and_fits(n, h, w):
    plan = ec.entry_plan(n, h, w)
    tx, ty, tn = plan["tiles"]
    assert plan["tile"] == (8, 8) and tn == n
    assert tx * 8 == w // 4 and (ty - 1) * 8 < h // 4 <= ty * 8
    assert plan["grid"] == min(132, tx * ty * n)
    assert plan["smem"] <= ec.SMEM_LIMIT
    regions = plan["regions"]
    assert max(o + s for o, s in regions.values()) + 1024 == plan["smem"]
    for name in ("w0", "w1", "a0", "a1"):  # wgmma's 128-byte-swizzled operands
        assert regions[name][0] % 1024 == 0
    assert regions["img"][0] % 128 == 0 and regions["c1"][0] % 16 == 0
    # the slots hold the largest operand each takes, and an A tile of 128 channels
    sizes = {name: npad * kp * 2 for name, npad, kp in ec.OPERANDS}
    assert regions["w0"][1] >= max(sizes[k] for k in ("conv2", "pw1", "pw3"))
    assert regions["w1"][1] >= max(sizes[k] for k in ("conv1", "skip", "pw2"))
    assert regions["a0"][1] == regions["a1"][1] == 64 * 128 * 2


def test_plan_products_fill_whole_m_tiles():
    """Every product's M is whole 64-row tiles covering the pixels it
    computes, with as many for each of the three warpgroups where the
    product is split by rows."""
    ext, mt = ec.EXTENTS, ec.M_TILES
    rows = {"conv1": ext["c1"][0] * ext["c1"][1],
            "conv2": ext["x2"][0] * ext["c1"][1],  # a raster as wide as c1
            "skip": 64, "pw1": ext["x3"][0] * ext["x3"][1],
            "pw2": ext["x4"][0] * ext["x4"][1], "pw3": 64}
    split = ("conv1", "conv2", "pw1", "pw2")
    for name, m in rows.items():  # at most the tiles a multiple of 3 adds are spare
        assert m <= mt[name] * 64 < m + (64 * ec.WARPGROUPS if name in split else 64), name
    for name in split:
        assert mt[name] % ec.WARPGROUPS == 0, name
    # conv2's shifted reads of the rows it keeps stay inside c1's channel
    # planes, the spare rows' inside the stage area
    w = ext["c1"][1]
    assert (ext["x2"][0] - 1) * w + ext["x2"][1] - 1 + 2 * w + 2 < ec.C1_PLANE_PIXELS
    reg = ec.entry_plan(1, 64, 128)["regions"]
    last = reg["c1"][0] + (3 * ec.C1_PLANE_PIXELS + mt["conv2"] * 64 + 2 * w + 2) * 16
    assert last <= reg["x2"][0] + reg["x2"][1]
    # each stage reads its 3x3 neighbourhoods inside the stage before
    for a, b in (("c1", "x2"), ("x2", "x3"), ("x3", "x4")):
        assert ext[a][0] == ext[b][0] + 2 and ec.ORIGINS[a] == ec.ORIGINS[b] - 1
    assert 2 * 7 + 2 < ext["x4"][0] and 2 * 7 + 3 < ext["x2"][0]  # sep3's dw, the skip


def test_plan_rejects_shapes_outside_the_gate():
    with pytest.raises(ValueError):
        ec.entry_plan(1, 1024, 2000)
    with pytest.raises(ValueError):
        ec.entry_plan(1, 28, 64)


def _chunk_reads(p0, width, in_width, in_base, in_pix, total):
    """Byte range [lo, hi] of the stage before that the depthwise taps of
    rows p0 .. p0 + 63 (a raster ``width`` wide, ``total`` pixels) read."""
    last = min(p0 + 63, total - 1)
    lo = (p0 // width) * in_width + p0 % width
    hi = (last // width + 2) * in_width + last % width + 2
    return in_base + lo * in_pix, in_base + (hi + 1) * in_pix - 1


def _taps_before_write(chunks, tap_waits, warpgroups=ec.WARPGROUPS):
    """before[m]: the chunks whose taps the kernel finishes before chunk m's
    epilogue writes. Warpgroup m % 3 runs chunks m % 3, m % 3 + 3, ... in
    program order (taps, product, epilogue); chunk m's epilogue waits for
    the taps of chunks m - tap_waits .. m - 1. Taps of chunk j come after
    the epilogue of chunk j - 3, so after every tap that one waited for."""
    before = []
    for m in range(chunks):
        def ahead(j):  # taps ordered before chunk j's taps
            return before[j - warpgroups] if j >= warpgroups else set()
        got = {m} | ahead(m)
        for j in range(max(0, m - tap_waits), m):
            got |= {j} | ahead(j)
        before.append(got)
    return before


def test_taps_before_write_sees_a_missing_wait():
    """With one wait (the chunk just before) chunk 4's epilogue is not
    ordered after chunk 2's taps, which another warpgroup runs."""
    assert 2 not in _taps_before_write(6, 1)[4]
    assert _taps_before_write(6, 5) == [set(range(m + 1)) for m in range(6)]


@pytest.mark.parametrize("stage", ["sep1", "sep2"])
def test_plan_stages_overwrite_only_rows_read_before(stage):
    """sep1 writes x3 over x2, sep2 x4 over x3: chunk m's output rows may
    lie only where the taps of no chunk that the kernel's barriers leave
    unordered with its epilogue read (``_taps_before_write`` at the plan's
    ``tap_waits``)."""
    plan = ec.entry_plan(1, 64, 128)
    reg = plan["regions"]
    if stage == "sep1":
        src, dst, w_in, w_out, total = "x2", "x3", 21, 19, 361
    else:
        src, dst, w_in, w_out, total = "x3", "x4", 19, 17, 289
    pix_in, pix_out = ec.PIXEL_BYTES[src], ec.PIXEL_BYTES[dst]
    chunks = ec.M_TILES["pw1" if stage == "sep1" else "pw2"]
    before = _taps_before_write(chunks, plan["tap_waits"])
    for m in range(chunks):
        if 64 * m >= total:
            continue
        w_lo = reg[dst][0] + 64 * m * pix_out
        w_hi = reg[dst][0] + min(64 * m + 64, total) * pix_out - 1
        for j in range(chunks):
            if 64 * j >= total or j in before[m]:
                continue
            r_lo, r_hi = _chunk_reads(64 * j, w_out, w_in, reg[src][0], pix_in, total)
            assert w_hi < r_lo or r_hi < w_lo, (stage, m, j)
    # and the written stage fits the area
    assert reg[dst][0] + total * pix_out <= reg["prm"][0]


def test_plan_regions_live_at_once_are_disjoint():
    reg = ec.entry_plan(1, 64, 128)["regions"]

    def apart(a, b):
        (oa, sa), (ob, sb) = reg[a], reg[b]
        return oa + sa <= ob or ob + sb <= oa

    # conv1 reads img, writes c1; conv2 reads c1, writes x2; the next
    # tile's patch lands while sep3 reads x4; slots, params, barriers apart
    assert apart("img", "c1") and apart("c1", "x2") and apart("img", "x4")
    for a in ("w0", "w1", "a0", "a1", "prm", "bar", "aff"):
        for b in reg:
            assert a == b or apart(a, b), (a, b)


# ------------------------------------------------------------------- packing
def _unswizzle(flat, n, k_pad):
    """(N, k_pad) from an operand in boxes of [N][64], chunk c of row r at
    c ^ (r % 8): an independent walk over every element."""
    out = np.zeros((n, k_pad), dtype=flat.dtype)
    for k in range(k_pad):
        box, col = divmod(k, 64)
        for r in range(n):
            off = box * n * 64 + r * 64 + (((col // 8) ^ (r % 8)) * 8) + col % 8
            out[r, k] = flat[off]
    return out


def test_pack_operands_unswizzle_to_bf16_weights():
    stem, seps, skip = _params(5)
    x = torch.zeros(1, 64, 128, 3, dtype=torch.bfloat16)
    ops = ec.pack_operands(x, stem, seps, skip)
    assert ops.dtype == torch.bfloat16
    assert ops.numel() == sum(n * kp for _, n, kp in ec.OPERANDS) == 71680
    flat = ops.view(torch.int16).numpy()
    weights = (stem[0].reshape(27, 32), stem[3].reshape(288, 64), skip[0].reshape(64, 128),
               *(s[3].reshape(s[3].shape[2], 128) for s in seps))
    pos = 0
    for (name, n, kp), wt in zip(ec.OPERANDS, weights):
        got = _unswizzle(flat[pos:pos + n * kp], n, kp)
        want = wt.to(torch.bfloat16).view(torch.int16).numpy().T
        k = want.shape[1]
        assert np.array_equal(got[:, :k], want), name
        assert not got[:, k:].any(), name  # K padding is +0.0
        pos += n * kp


def test_pack_weights_f32_buffer_unchanged():
    stem, seps, skip = _params(6)
    x = torch.zeros(1, 64, 128, 3, dtype=torch.bfloat16)
    packed = ec.pack_weights(x, stem, seps, skip)
    order = [t for g in (stem[:3], stem[3:], *(p for s in seps for p in (s[:3], s[3:])), skip)
             for t in g]
    want = torch.cat([(t.to(torch.bfloat16) if t.dim() == 4 else t).float().reshape(-1)
                      for t in order])
    assert packed.dtype == torch.float32 and torch.equal(packed, want)


def test_cpu_input_ignores_packed_pair():
    stem, seps, skip = _params(7)
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 32, 64, 3).astype(np.float32))
    pair = (ec.pack_weights(x, stem, seps, skip), ec.pack_operands(x, stem, seps, skip))
    before = ec.fused_stem_block1.launches
    got = ec.fused_stem_block1(x, stem, seps, skip, packed=pair)
    assert ec.fused_stem_block1.launches == before
    assert torch.equal(got, ec.fused_stem_block1_plain(x, stem, seps, skip))


# ----------------------------------------------------------------- emulation
def _emulate(x, stem, seps, skip):
    """The kernel's chain tile by tile in f32 (see the module docstring).
    The stage area X holds 16-byte units of 8 channels at the plan's
    offsets: c1 as four channel planes of C1_PLANE_PIXELS pixels, x2, x3,
    x4 pixel-major, PIXEL_BYTES a pixel."""
    x = x.numpy()
    n, h, w, _ = x.shape
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    plan = ec.entry_plan(n, h, w)
    reg = plan["regions"]
    base = reg["c1"][0]
    u = {k: (reg[k][0] - base) // 16 for k in ("c1", "x2", "x3", "x4")}
    X = np.full(((reg["prm"][0] - base) // 16, 8), np.nan, np.float32)
    f = [t.numpy() for t in stem]
    k1, a1, b1, k2, a2, b2 = f
    sp = [[t.numpy() for t in s] for s in seps]
    wsk, a_s, b_s = (t.numpy() for t in skip)
    out = np.full((n, h4, w4, 128), np.nan, np.float32)

    def affine(acc, a, b, relu=False):
        y = acc * a + b
        return np.maximum(y, 0) if relu else y

    def inside(r, c, org, R, C):
        rr, cc = R + org + r, C + org + c
        return ((rr >= 0) & (rr < h2) & (cc >= 0) & (cc < w2))[:, None]

    per = {k: ec.PIXEL_BYTES[k] // 16 for k in ("x2", "x3", "x4")}  # units a pixel

    def put(pix, y, stage):  # y (rows, channels) into X
        for j in range(y.shape[1] // 8):
            if stage == "c1":
                X[u["c1"] + j * ec.C1_PLANE_PIXELS + pix] = y[:, 8 * j:8 * j + 8]
            else:
                X[u[stage] + pix * per[stage] + j] = y[:, 8 * j:8 * j + 8]

    def get(pix, stage, ch):
        return np.concatenate([X[u[stage] + pix * per[stage] + j] for j in range(ch // 8)], 1)

    off = np.array([(k // 9) * 144 + ((k % 9) // 3) * 3 + k % 3 for k in range(27)])
    tx, ty, _ = plan["tiles"]
    for b in range(n):
        for t in range(ty):
            for s in range(tx):
                t0, u0 = 8 * t, 8 * s
                R, C = 2 * t0, 2 * u0
                # the image patch, zeros outside the image (TMA's fill)
                patch = np.zeros((47, 48, 3), np.float32)
                r0, c0 = 4 * t0 - 9, 4 * u0 - 9
                rs, cs = max(r0, 0), max(c0, 0)
                re, ce = min(r0 + 47, h), min(c0 + 48, w)
                patch[rs - r0:re - r0, cs - c0:ce - c0] = x[b, rs:re, cs:ce]
                patch = patch.reshape(-1)
                # conv1: rows p of the 23-wide c1 raster, A from the patch
                for mt in range(ec.M_TILES["conv1"]):
                    p = np.minimum(64 * mt + np.arange(64), 528)
                    r, c = p // 23, p % 23
                    A = patch[(288 * r + 6 * c)[:, None] + off[None, :]]
                    y = affine(A @ k1.reshape(27, 32), a1, b1, True)
                    y = np.where(inside(r, c, -4, R, C), y, 0)
                    keep = 64 * mt + np.arange(64) < 529
                    put(p[keep], y[keep], "c1")
                # conv2: the tap (dy, dx) shifts the rows by dy * 23 + dx
                for mt in range(ec.M_TILES["conv2"]):
                    o = 64 * mt + np.arange(64)
                    acc = np.zeros((64, 64), np.float32)
                    for tap in range(9):
                        q = o + (tap // 3) * 23 + tap % 3
                        A = np.concatenate([X[u["c1"] + j * ec.C1_PLANE_PIXELS + q]
                                            for j in range(4)], 1)
                        with np.errstate(invalid="ignore"):
                            acc += A @ k2.reshape(288, 64)[32 * tap:32 * tap + 32]
                    r, c = o // 23, o % 23
                    keep = (r < 21) & (c < 21)
                    y = affine(acc, a2, b2, True)
                    y = np.where(inside(r, c, -3, R, C), y, 0)
                    put((r * 21 + c)[keep], y[keep], "x2")
                # the skip: x2 at stride 2 from (3, 3)
                rho = np.arange(64)
                A = get((2 * (rho // 8) + 3) * 21 + 2 * (rho % 8) + 3, "x2", 64)
                sk = affine(A @ wsk.reshape(64, 128), a_s, b_s)
                # sep1, sep2: chunk by chunk, the taps of chunk m then its
                # product's rows written, which the kernel's barriers allow
                # only if they order every chunk before m ahead of m's write;
                # then every chunk they leave unordered reads after it.
                # sep3 on the 8 x 8 tile
                before = _taps_before_write(ec.M_TILES["pw1"], plan["tap_waits"])
                assert before == [set(range(m + 1)) for m in range(len(before))]
                for si, (src, dst, wi, wo, total, org, ci) in enumerate(
                        (("x2", "x3", 21, 19, 361, -2, 64), ("x3", "x4", 19, 17, 289, -1, 128))):
                    dw, ad, bd, pw, ap, bp = sp[si]
                    for m in range(ec.M_TILES["pw1" if si == 0 else "pw2"]):
                        P = 64 * m + np.arange(64)
                        P = P[P < total]
                        if not len(P):
                            continue
                        r, c = P // wo, P % wo
                        acc = np.zeros((len(P), ci), np.float32)
                        for tap in range(9):
                            acc += get((r + tap // 3) * wi + c + tap % 3, src, ci) * \
                                dw[tap // 3, tap % 3, 0]
                        d = affine(acc, ad, bd)
                        y = affine(d @ pw.reshape(ci, 128), ap, bp)
                        y = np.where(inside(r, c, org, R, C), y, 0)
                        put(P, y, dst)
                dw, ad, bd, pw, ap, bp = sp[2]
                r, c = rho // 8, rho % 8
                acc = np.zeros((64, 128), np.float32)
                for tap in range(9):
                    acc += get((2 * r + tap // 3) * 17 + 2 * c + tap % 3, "x4", 128) * \
                        dw[tap // 3, tap % 3, 0]
                y = affine(affine(acc, ad, bd) @ pw.reshape(128, 128), ap, bp) + sk
                keep = t0 + r < h4
                out[b, (t0 + r)[keep], (u0 + c)[keep]] = y[keep]
    return out


@pytest.mark.parametrize("n,h,w", [(1, 64, 128), (1, 32, 64), (1, 48, 64), (2, 32, 128)])
def test_emulated_chain_matches_plain(n, h, w):
    """One tile tall (32 rows), ragged (48: 1.5 tiles), two images."""
    stem, seps, skip = _params(n * h + w)
    x = torch.from_numpy(np.random.RandomState(h + w).randn(n, h, w, 3).astype(np.float32))
    want = ec.fused_stem_block1_plain(x, stem, seps, skip).numpy()
    got = _emulate(x, stem, seps, skip)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
