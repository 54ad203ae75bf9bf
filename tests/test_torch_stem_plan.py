"""The bf16 stem kernel's plan, operand packing and walk
(segmentron_tpu_torch/ops/entrychain.py, csrc/entrychain.cu's
stem_wgmma_kernel), on the CPU.

The kernel runs only on the card. These tests hold what surrounds it:
``stem_plan`` (the mirror chip_smoke.py holds to the source's), the stem's
form of ``pack_operands`` against an independent un-swizzle, the schedules
that order its shared memory (the staging slots its TMA stores read, the two
c1 buffers its producers write and its consumers read, the consumers' turns
on the tensor cores), and a tile-by-tile f32 emulation of its walk: the
plan's tile origins, the patch as the kernel's 4-D box (a row's lead to the
16-byte chunk it starts in), conv1's M tiles one c1 raster row each, c1 as
four planes of 8 channels, conv2 transposed over a raster 64 wide in chains
of 128 pixels with each tap a shift of 64 dy + dx pixels, and each chain's
two output rows stored as boxes of 62 pixels clipped at the image's edge.
Pixels the kernel never writes start as NaN, so a wrong shift, halo, edge
or clip moves whole pixels.
"""

import numpy as np
import pytest
import torch

from segmentron_tpu_torch.ops import entrychain as ec

torch.set_num_threads(2)

SHAPES = [(1, 1024, 2048), (2, 1024, 2048), (1, 1040, 2048), (1, 32, 32), (2, 64, 128)]


def _stem(seed):
    rng = np.random.RandomState(seed)

    def t(*s, scale=1.0, pos=False):
        v = rng.rand(*s) + 0.5 if pos else rng.randn(*s) * scale
        return torch.from_numpy(v.astype(np.float32))

    return (t(3, 3, 3, 32, scale=0.2), t(32, pos=True), t(32, scale=0.3),
            t(3, 3, 32, 64, scale=0.1), t(64, pos=True), t(64, scale=0.3))


# ---------------------------------------------------------------------- plan
@pytest.mark.parametrize("n,h,w", SHAPES)
def test_stem_plan_covers_output_and_fits(n, h, w):
    plan = ec.stem_plan(n, h, w)
    rows, cols = plan["tile"]
    tx, ty, tn = plan["tiles"]
    assert (rows, cols, plan["raster"]) == (8, 62, 64) and tn == n
    assert ty * rows == h // 2 and (tx - 1) * cols < w // 2 <= tx * cols
    assert plan["grid"] == min(132, tx * ty * n)
    assert plan["threads"] == 128 * ec.STEM_WARPGROUPS
    regions = plan["regions"]
    assert max(o + s for o, s in regions.values()) + 1024 == plan["smem"] <= ec.SMEM_LIMIT
    # 128-byte-swizzled operands and staging slots, TMA's patch boxes
    for name in ("w2", "w1", "stage", "img"):
        assert regions[name][0] % 1024 == 0, name
    assert regions["c1"][0] % 16 == 0 and regions["bar"][0] % 8 == 0
    sizes = {name: npad * kp * 2 for name, npad, kp in ec.OPERANDS}
    assert regions["w2"][1] == sizes["conv2"] and regions["w1"][1] == sizes["conv1"]
    assert regions["stage"][1] == plan["chains"][0] * plan["slot"]
    assert regions["c1"][1] == 2 * 4 * plan["c1"][1] * 16
    assert regions["img"][1] >= 2 * plan["image_box"][0] * plan["image_box"][1] * 16


def test_stem_plan_regions_are_disjoint():
    """Every region is live for the whole kernel (two c1 buffers and two
    patches are in use at once), so no two may overlap."""
    regions = sorted(ec.stem_plan(1, 64, 128)["regions"].values())
    for (oa, sa), (ob, _) in zip(regions, regions[1:]):
        assert oa + sa <= ob


def test_stem_plan_rejects_shapes_outside_the_gate():
    for n, h, w in [(1, 1024, 2000), (1, 30, 64), (1, 1028, 2048), (1, 16, 64), (0, 64, 64)]:
        with pytest.raises(ValueError):
            ec.stem_plan(n, h, w)
    for h, w in [(32, 32), (48, 160), (1040, 2048)]:
        assert ec.stem_supported(h, w, 3)
        ec.stem_plan(1, h, w)


def test_stem_raster_fills_whole_m_tiles():
    """conv1's M is whole 64-row tiles, one for each c1 raster row; conv2's
    N is whole chains; every kept output pixel reads only c1 pixels conv1
    writes, and the spare columns' reads stay inside the planes."""
    plan = ec.stem_plan(1, 64, 128)
    rows, cols = plan["tile"]
    raster = plan["raster"]
    c1_rows, plane = plan["c1"]
    chains, chain_n = plan["chains"]
    assert c1_rows == rows + 2 and c1_rows * raster == 64 * plan["conv1_m_tiles"]
    assert rows * raster == chains * chain_n and chain_n % 64 == 0 and chain_n <= 256
    assert chain_n % raster == 0  # a chain is whole output rows
    o = np.arange(rows * raster)
    last = o + 2 * raster + 2  # the tap (2, 2)
    kept = o % raster < cols
    assert last[kept].max() < c1_rows * raster <= last.max() < plane
    # the raster's spare columns and the ragged last tile column: 3 % each
    assert raster - cols == 2 and (1 - cols / raster) < 0.04


def test_stem_patch_box_holds_every_tap():
    """The patch is a 4-D box (8 elements, 50 chunks, 21 rows) of the image
    seen as (n, h, 3 w / 8, 8), its innermost start 0: for every tile column
    the chunk that holds column 2 C0 - 3 starts it, and the row's lead and
    the last c1 column's taps fit the box's 400 elements."""
    rows, chunks = ec.STEM_IMAGE_BOX
    assert rows == 2 * ec.STEM_C1_ROWS + 1
    for tx in range(40):
        e0 = 6 * ec.STEM_TILE[1] * tx - 9  # element of column 2 C0 - 3, channel 0
        start, lead = (e0 >> 3) * 8, e0 & 7
        assert start + lead == e0 and lead in (3, 7)
        assert lead + 6 * (ec.STEM_RASTER - 1) + 3 * 2 + 2 < 8 * chunks


# --------------------------------------------------------------- schedules
def test_stem_staging_slot_not_written_while_read():
    """Each consumer writes chain k's slot k, then one thread issues its
    stores as one bulk group; before writing a slot it waits until at most
    one of its groups may still read (``cp.async.bulk.wait_group.read 1``).
    The groups that may still be reading never include the slot written."""
    chains = ec.STEM_CHAINS
    per = chains // 2
    for count in range(1, 6):
        for h in range(2):
            groups = []  # slots of this thread's groups, oldest first
            for _ in range(count):
                for c in range(per):
                    slot = per * h + c
                    pending = groups[-1:]  # wait_group.read 1
                    assert slot not in pending
                    groups.append(slot)
    # the two consumers' slots are apart
    assert {0, 1} & {2, 3} == set() and per == 2


def _mbar_passes(completed, parity):
    """try_wait.parity: the phase of ``parity`` has completed (the
    barrier's completed phases are never two ahead of a waiter here)."""
    return completed % 2 != parity


def test_stem_c1_buffers_handoff():
    """Producers write c1 buffer i % 2 for tile i once the consumers have
    read tile i - 2 from it (empty barrier, parity ((i >> 1) - 1) & 1);
    the consumers read tile i once both producers wrote it (full barrier,
    parity (i >> 1) & 1). Every interleaving the waits allow keeps a
    buffer's write after the read of the tile before in it, and its read
    after its write."""
    rng = np.random.RandomState(0)
    for count in (1, 2, 3, 7):
        for _ in range(50):
            full, empty = [0, 0], [0, 0]
            written, read = [-1, -1], [-1, -1]  # the tile last written, read in a buffer
            p = c = 0
            while c < count:
                can_p = p < count and (p < 2 or _mbar_passes(empty[p % 2], ((p >> 1) - 1) & 1))
                can_c = _mbar_passes(full[c % 2], (c >> 1) & 1)
                assert can_p or can_c, "deadlock"
                if can_p and (not can_c or rng.rand() < 0.5):
                    assert read[p % 2] == p - 2 or p < 2  # the tile before was read
                    written[p % 2] = p
                    full[p % 2] += 1
                    p += 1
                else:
                    assert written[c % 2] == c
                    read[c % 2] = c
                    empty[c % 2] += 1
                    c += 1


def test_stem_consumer_turns_balance():
    """The consumers issue chains in turns on named barriers (consumer 0
    first): consumer h syncs on barrier h before each chain and arrives on
    the other's after it, consumer 1 arrives once ahead and not after its
    last. Each barrier gets as many arrivals as syncs, and the tensor cores
    see the chains alternate between the consumers."""
    per = ec.STEM_CHAINS // 2
    for count in range(1, 8):
        arrivals = [1, 0]  # consumer 1's arrival ahead, on barrier 0
        syncs = [0, 0]
        order = []
        pending = [[(i, c) for i in range(count) for c in range(per)] for _ in range(2)]
        turn = 0
        while pending[0] or pending[1]:
            h = turn
            assert arrivals[h] > syncs[h], "a consumer would wait forever"
            syncs[h] += 1
            i, c = pending[h].pop(0)
            order.append(h)
            if h == 0 or i + 1 < count or c + 1 < per:
                arrivals[1 - h] += 1
            turn = 1 - h
        assert arrivals == syncs == [count * per] * 2
        assert order == [0, 1] * (count * per)


# ------------------------------------------------------------------- packing
def _unswizzle(flat, n, k_pad):
    """(N, k_pad) from an operand in boxes of [N][64], chunk c of row r at
    c ^ (r % 8): an independent walk over every element."""
    out = np.zeros((n, k_pad), dtype=flat.dtype)
    for k in range(k_pad):
        box, col = divmod(k, 64)
        for r in range(n):
            out[r, k] = flat[box * n * 64 + r * 64 + (((col // 8) ^ (r % 8)) * 8) + col % 8]
    return out


def test_pack_operands_stem_form_unswizzles_to_bf16_weights():
    stem = _stem(3)
    x = torch.zeros(1, 64, 128, 3, dtype=torch.bfloat16)
    ops = ec.pack_operands(x, stem)
    assert ops.dtype == torch.bfloat16 and ops.numel() == 32 * 64 + 64 * 320 == 22528
    flat = ops.view(torch.int16).numpy()
    pos = 0
    weights = (stem[0].reshape(27, 32), stem[3].reshape(288, 64))
    for (name, n, kp), wt in zip(ec.OPERANDS[:2], weights):
        got = _unswizzle(flat[pos:pos + n * kp], n, kp)
        want = wt.to(torch.bfloat16).view(torch.int16).numpy().T
        assert np.array_equal(got[:, :want.shape[1]], want), name
        assert not got[:, want.shape[1]:].any(), name  # K padding is +0.0
        pos += n * kp


def test_pack_operands_stem_form_is_the_full_form_prefix():
    """The stem kernel reads conv1 and conv2 at the offsets stem + block1
    reads them, so the stem's form is the full buffer's prefix."""
    stem = _stem(4)
    rng = np.random.RandomState(4)

    def t(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32))

    seps = tuple((t(3, 3, 1, c), t(c), t(c), t(1, 1, c, 128), t(128), t(128))
                 for c in (64, 128, 128))
    skip = (t(1, 1, 64, 128), t(128), t(128))
    x = torch.zeros(1, 64, 128, 3, dtype=torch.bfloat16)
    full = ec.pack_operands(x, stem, seps, skip)
    stem_only = ec.pack_operands(x, stem)
    assert torch.equal(full[:stem_only.numel()].view(torch.int16), stem_only.view(torch.int16))


def test_cpu_input_with_packed_pair_takes_plain_version():
    stem = _stem(5)
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 32, 64, 3).astype(np.float32))
    pair = (ec.pack_weights(x, stem), ec.pack_operands(x, stem))
    before = ec.fused_stem.launches
    got = ec.fused_stem(x, *stem, packed=pair)
    assert ec.fused_stem.launches == before
    assert torch.equal(got, ec.fused_stem_plain(x, *stem))


# ----------------------------------------------------------------- emulation
def _emulate(x, stem, shift_row=None):
    """The kernel's walk tile by tile in f32 (see the module docstring);
    ``shift_row``: the raster width conv2's taps shift by (the kernel's is
    the plan's raster)."""
    x = x.numpy()
    n, h, w, _ = x.shape
    h2, w2 = h // 2, w // 2
    plan = ec.stem_plan(n, h, w)
    rows, cols = plan["tile"]
    raster = plan["raster"]
    shift_row = raster if shift_row is None else shift_row
    c1_rows, plane = plan["c1"]
    chains, chain_n = plan["chains"]
    box_rows, box_chunks = plan["image_box"]
    k1, a1, b1, k2, a2, b2 = (t.numpy() for t in stem)
    w1 = k1.reshape(27, 32)
    w2t = k2.reshape(9, 32, 64).transpose(0, 2, 1)  # conv2's A: tap, out channel, in channel
    flat = x.reshape(n, h, w * 3)
    out = np.full((n, h2, w2, 64), np.nan, np.float32)
    off = np.array([(k // 9) * 8 * box_chunks + ((k % 9) // 3) * 3 + k % 3 for k in range(27)])
    tx, ty, _ = plan["tiles"]
    for b in range(n):
        for t in range(ty):
            for s in range(tx):
                r0, c0 = rows * t, cols * s
                # the patch: the box from chunk (6 C0 - 9) >> 3, rows from
                # 2 R0 - 3, zeros past every edge (TMA's fill)
                e0 = 6 * c0 - 9
                start, lead = (e0 >> 3) * 8, e0 & 7
                patch = np.zeros((box_rows, 8 * box_chunks), np.float32)
                for pr in range(box_rows):
                    ir = 2 * r0 - 3 + pr
                    if 0 <= ir < h:
                        lo, hi = max(start, 0), min(start + 8 * box_chunks, 3 * w)
                        patch[pr, lo - start:hi - start] = flat[b, ir, lo:hi]
                patch = patch.reshape(-1)
                c1 = np.full((4, plane, 8), np.nan, np.float32)
                # conv1: M tile r is c1 raster row r
                for r in range(c1_rows):
                    c = np.arange(raster)
                    A = patch[(2 * r * 8 * box_chunks + 6 * c + lead)[:, None] + off[None, :]]
                    y = np.maximum((A @ w1) * a1 + b1, 0)
                    rr, cc = r0 - 1 + r, c0 - 1 + c
                    inside = (0 <= rr < h2) & (cc >= 0) & (cc < w2)
                    y = np.where(inside[:, None], y, 0)
                    for j in range(4):
                        c1[j, raster * r + c] = y[:, 8 * j:8 * j + 8]
                # conv2: chains of chain_n raster pixels, transposed
                for k in range(chains):
                    o = chain_n * k + np.arange(chain_n)
                    acc = np.zeros((64, chain_n), np.float32)
                    for tap in range(9):
                        q = o + (tap // 3) * shift_row + tap % 3
                        B = np.concatenate([c1[j, q] for j in range(4)], 1)  # (pixels, 32)
                        with np.errstate(invalid="ignore"):
                            acc += w2t[tap] @ B.T
                    y = np.maximum(acc * a2[:, None] + b2[:, None], 0).T  # (pixels, 64)
                    # two stores of the output box: 62 pixels of each output
                    # row, clipped at the right edge
                    for rr in range(chain_n // raster):
                        keep = np.arange(cols)
                        keep = keep[c0 + keep < w2]
                        out[b, r0 + (chain_n // raster) * k + rr, c0 + keep] = y[raster * rr + keep]
    return out


@pytest.mark.parametrize("n,h,w", [(1, 32, 32), (1, 48, 160), (2, 64, 128), (1, 32, 256)])
def test_emulated_stem_matches_plain(n, h, w):
    """One tile (16 x 16 at 1/2 resolution), a last tile column of 18
    pixels, two images with a last tile column of 2, three tile columns.
    Tile rows are never ragged: the gate makes H/2 a multiple of 8."""
    stem = _stem(n * h + w)
    x = torch.from_numpy(np.random.RandomState(h + w).randn(n, h, w, 3).astype(np.float32))
    want = ec.fused_stem_plain(x, *stem).numpy()
    got = _emulate(x, stem)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_emulation_sees_a_wrong_tap_shift():
    """Taps shifted by the tile's width (62) instead of the raster's (64)
    move whole columns."""
    stem = _stem(9)
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 32, 64, 3).astype(np.float32))
    want = ec.fused_stem_plain(x, *stem).numpy()
    got = _emulate(x, stem, shift_row=ec.STEM_TILE[1])
    assert not np.allclose(np.nan_to_num(got), want, atol=1e-3)
