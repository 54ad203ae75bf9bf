"""The separable conv's block ends on the CPU (``csrc/sepconv.cu``,
``ops/sepconv.py``): where the plan mirror ``sepconv_plan`` sends every skip
case of ``chip_smoke.py`` and every block end of the flagship, the wgmma
kernel's sum and conv skips emulated (the x_in boxes as TMA lays them out,
128-byte swizzled, read by the epilogue or by ``wgmma`` as its A tile; the
schedule of the sum skip's two slots), and the plain version the card holds
the kernel to against the JAX Pallas kernel with ``int8_dot`` and a
stride-1 conv skip, in interpret mode."""

import numpy as np
import pytest
import torch

from chip_smoke import FLAGSHIP_SEPCONV_LAYERS, SEPCONV_CASES
from segmentron_tpu.ops import sepconv as js
from segmentron_tpu_torch.ops import sepconv as ts

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100
SKIP_CASES = [c for c in SEPCONV_CASES if c.get("skip")]
SKIP_LAYERS = [layer for layer in FLAGSHIP_SEPCONV_LAYERS if layer[5]]
FLAGSHIP_CIN = {(1, 256, 512, 256): 128, (1, 128, 256, 728): 256}  # conv skips' x_in channels


def _routes(shape, co, d, stride, skip, int8, cin):
    """{dtype: plan} of a block end in f32 and bf16."""
    n, h, w, c = shape
    return {dt: ts.sepconv_plan(n, h, w, c, co, d, stride, skip, dt, int8, cin=cin)
            for dt in (torch.float32, torch.bfloat16)}


def _check_routes(plans, stride):
    """bf16 at stride 1 on the wgmma kernel, stride 2 and f32 on the older
    kernels; every plan within the card's shared memory."""
    for dt, p in plans.items():
        assert (p["kernel"] == "wgmma") == (dt == torch.bfloat16 and stride == 1), (dt, p)
        assert p["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("case", SKIP_CASES, ids=lambda c: c["what"].replace(" ", "_"))
def test_skip_case_routes(case):
    _check_routes(_routes(case["shape"], case["co"], case["d"], case.get("stride", 1),
                          case["skip"], case["int8"], case.get("cin", 0)), case.get("stride", 1))


@pytest.mark.parametrize("layer", SKIP_LAYERS, ids=lambda lay: f"{lay[5]}-s{lay[4]}-x{lay[7]}")
def test_flagship_block_end_routes(layer):
    fn, shape, co, d, stride, skip, int8, _ = layer
    cin = FLAGSHIP_CIN[shape] if skip == "conv" else 0
    _check_routes(_routes(shape, co, d, stride, skip, int8, cin), stride)


def test_conv_skip_plan_by_hand():
    """block3's end at output stride 8, (1,128,256,728) -> 728, d = 1,
    Cin 256, int8: 1 KB of slack, three A slots, two slots of both affines
    (32 x 192 bytes), 144 B of barriers, two x_in boxes and four barriers,
    two input stages (10 x 10 x 128 bf16 and 11 x 128 f32), two weight
    stages of 384 rows x 128 bytes."""
    p = ts.sepconv_plan(1, 128, 256, 728, 728, 1, 1, "conv", torch.bfloat16, True, cin=256)
    assert p == dict(kernel="wgmma", tile=(8, 8), grid=(132, 1, 1), co_split=2, co_block=384,
                     n_wg=192, stages=2, in_stages=2,
                     smem=1024 + 24576 + 2 * 6144 + 144 + (16384 + 32) + 2 * (25600 + 5632)
                     + 2 * 49152)


def test_skip_gate():
    """x_in's channels must be whole 16-byte rows for its TMA map; a conv
    skip without x_in channels, or a sum skip at stride 2, no kernel takes."""
    base = (1, 128, 256, 728, 728, 1, 1, "conv", torch.bfloat16, True)
    assert ts.sepconv_plan(*base, cin=252)["kernel"] == "resident"
    assert ts.sepconv_plan(*base, cin=256)["kernel"] == "wgmma"
    with pytest.raises(ValueError):
        ts.sepconv_plan(*base)
    with pytest.raises(ValueError):
        ts.sepconv_plan(1, 128, 256, 728, 728, 1, 2, "sum", torch.bfloat16, True)


# ------------------------------------------------ the kernel's index arithmetic
def _swizzled(logical):
    """128-byte swizzle of a byte offset from a 1024-byte-aligned base:
    address bits 4-6 take their XOR with bits 7-9 (the 16-byte chunk c of
    128-byte row r lands at chunk c ^ (r % 8))."""
    return logical ^ (((logical >> 7) & 7) << 4)


def _tma_box(src, r0, c0, ch0):
    """The box [64 channels][8 columns][8 rows] of the NHWC image ``src``
    (H, W, C) at pixel (r0, c0) and channel ch0 as TMA writes it to shared
    memory, 128-byte swizzled: a bytearray of 8 KB of bf16, zeros outside
    the image and past C."""
    h, w, c = src.shape
    raw = np.zeros(64 * 128, np.uint8)
    bits = src.view(np.uint16)
    for m in range(64):
        r, col = r0 + m // 8, c0 + m % 8
        for k in range(64):
            v = bits[r, col, ch0 + k] if r < h and col < w and ch0 + k < c else 0
            at = _swizzled(m * 128 + 2 * k)
            raw[at], raw[at + 1] = v & 0xFF, v >> 8
    return raw


def _bf16_bits(shape, rng):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return x.view(torch.int16).numpy().view(np.uint16), x


def _read_bf16(raw, at):
    return np.uint16(raw[at]) | (np.uint16(raw[at + 1]) << np.uint16(8))


@pytest.mark.parametrize("n", [192, 128])
def test_sum_epilogue_reads_each_x_in_once(n):
    """A warpgroup's epilogue over its N columns, box by box: thread (warp,
    lane) reads the x_in pairs of its fragment (rows 16 warp + g and + 8,
    channels 8 j + 2 q, + 1) at the staging address ((j % 8) ^ g) << 4 of
    the TMA box, adds them to the out affine's f32 result, and writes the
    bf16 pair there; the read-out's 16-byte chunk c8 of pixel m at chunk
    c8 ^ (m % 8) is then out = bf16(affine + x_in), every (pixel, channel)
    read exactly once. The image's last rows and columns lie past the
    tile's 8 x 8 and read as zeros."""
    rng = np.random.default_rng(n)
    h, w, co = 13, 11, n + 24
    bits, x_in = _bf16_bits((h, w, co), rng)
    r0, c0 = 8, 8  # the image's corner tile: 5 x 3 pixels inside
    affine = torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32))
    seen = np.zeros((64, n), int)
    for bx in range(n // 64):
        ch0 = 64 * bx
        box = _tma_box(bits, r0, c0, ch0)
        for t in range(128):
            lane, g, q = t % 32, (t % 32) // 4, t % 4
            row = (t // 32) * 16 + g
            for j in range(8 * bx, 8 * bx + 8):
                for r in (row, row + 8):
                    at = r * 128 + (((j % 8) ^ g) << 4) + 4 * q
                    pair = []
                    for e in range(2):
                        col = 8 * j + 2 * q + e
                        seen[r, col] += 1
                        xv = torch.tensor([_read_bf16(box, at + 2 * e)], dtype=torch.int32)
                        xv = xv.to(torch.int16).view(torch.bfloat16).float()
                        pr, pc = r0 + r // 8, c0 + r % 8
                        want = x_in[pr, pc, col].float() if pr < h and pc < w else 0.0
                        assert float(xv) == float(want)
                        pair.append((affine[r, col] + xv).to(torch.bfloat16))
                    for e, v in enumerate(pair):  # written over the pair it read
                        b = int(v.view(torch.int16)) & 0xFFFF
                        box[at + 2 * e], box[at + 2 * e + 1] = b & 0xFF, b >> 8
        for m in range(64):  # the read-out, in channel order
            for c8 in range(8):
                at = m * 128 + (((c8 ^ m) & 7) << 4)
                for e in range(8):
                    col = ch0 + 8 * c8 + e
                    got = torch.tensor([_read_bf16(box, at + 2 * e)], dtype=torch.int32)
                    got = got.to(torch.int16).view(torch.bfloat16).float()
                    pr, pc = r0 + m // 8, c0 + m % 8
                    xv = x_in[pr, pc, col].float() if pr < h and pc < w else torch.tensor(0.0)
                    assert float(got) == float((affine[m, col] + xv).to(torch.bfloat16))
    assert (seen == 1).all()


def _sum_slot_schedule(n_boxes, items):
    """The sum skip's x_in loads and reads of one warpgroup in its program
    order: (event, slot, box key). A box goes to the warpgroup's x_in slot
    ("x", even boxes) or its A slot ("a", odd); box bx + 1 is issued at the
    top of box bx, after the barrier that ends box bx - 1's read-out; an
    item's first box after the item before's epilogue."""
    ev = [("issue", "x", (0, 0))]
    for it in range(items):
        ev.append(("products done", "a", None))  # the A slots are free from here
        for bx in range(n_boxes):
            if bx + 1 < n_boxes:
                ev.append(("issue", "ax"[(bx + 1) % 2 == 0], (it, bx + 1)))
            ev.append(("wait", "ax"[bx % 2 == 0], (it, bx)))
            ev.append(("read out", "ax"[bx % 2 == 0], (it, bx)))
        ev.append(("taps", "a", None))  # the next item's taps write the A slots
        if it + 1 < items:
            ev.append(("issue", "x", (it + 1, 0)))
    return ev


@pytest.mark.parametrize("n_boxes", [3, 2])
def test_sum_slot_schedule(n_boxes):
    """No load lands in a slot whose box has not been read out, or in the
    A slot while the taps or products use it; each wait finds the box it
    reads, the k-th completion of the slot's barrier (parity k % 2), and
    every box of every item is read once."""
    holds, phase, waits, done, a_busy = {}, {"x": 0, "a": 0}, {"x": 0, "a": 0}, [], True
    pending = {"x": [], "a": []}
    for event, slot, key in _sum_slot_schedule(n_boxes, items=4):
        if event == "products done":
            a_busy = False
        elif event == "taps":
            a_busy = True
            assert holds.get("a") is None
        elif event == "issue":
            assert holds.get(slot) is None and not (slot == "a" and a_busy), (event, slot, key)
            holds[slot] = key
            pending[slot].append(phase[slot])
            phase[slot] += 1
        elif event == "wait":
            assert holds[slot] == key and pending[slot].pop(0) == waits[slot]
            waits[slot] += 1
        else:
            done.append(key)
            holds[slot] = None
    assert done == [(it, bx) for it in range(4) for bx in range(n_boxes)]


def _desc_a_read(raw_base, desc, m, k):
    """The address wgmma reads for element (m, k) of a K-major bf16 A (or
    B) operand with 128-byte swizzle from descriptor ``desc`` (start
    address >> 4 in bits 0-13, stride byte offset >> 4 in bits 32-45):
    rows 128 bytes apart within an 8-row group, groups SBO apart, K in the
    row from the start address (32 bytes a k16 slice), then swizzled."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 1  # 128-byte swizzle
    return _swizzled(start - raw_base + (m // 8) * sbo + (m % 8) * 128 + 2 * k)


def _sw128_desc(addr, lbo, sbo):
    """csrc/hopper.cuh's sw128_desc."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (1 << 62)


@pytest.mark.parametrize("r0,c0", [(0, 8), (8, 8)])
def test_conv_skip_box_is_the_a_tile(r0, c0):
    """The conv skip's x_in box of step j (64 channels from 64 j at the
    item's 8 x 8 pixels), as TMA writes it to a 1024-byte-aligned slot, is
    the A tile the four products of a step read through
    sw128_desc(slot + 32 kk, 16, 1024): A[m][16 kk + k] = x_in at pixel
    (r0 + m / 8, c0 + m % 8), channel 64 j + 16 kk + k, zeros past the
    image and past Cin. The same holds of the skw box as B (N rows of 64
    channels)."""
    rng = np.random.default_rng(r0 + c0)
    h, w, cin = 12, 14, 100  # Cin past a whole step: the last box is half zeros
    bits, _ = _bf16_bits((h, w, cin), rng)
    slot = 3 * 8192  # an x_in slot's offset in the 1024-byte-aligned region
    for j in range(2):
        box = _tma_box(bits, r0, c0, 64 * j)
        for kk in range(4):
            desc = _sw128_desc(slot + 32 * kk, 16, 1024)
            for m in range(64):
                for k in range(16):
                    at = _desc_a_read(slot, desc, m, k)
                    ch, pr, pc = 64 * j + 16 * kk + k, r0 + m // 8, c0 + m % 8
                    want = bits[pr, pc, ch] if pr < h and pc < w and ch < cin else 0
                    assert _read_bf16(box, at) == want
    # skw packed (Cop, Cinp): rows n0.. of N = 128, 64 channels from 64 j
    skw = rng.integers(0, 2 ** 16, (256, 128), dtype=np.uint16)
    for n0, j in ((0, 0), (128, 1)):
        raw = _tma_box(skw[n0:n0 + 128].reshape(16, 8, 128), 0, 0, 64 * j)  # 128 rows
        for kk in (0, 3):
            desc = _sw128_desc(slot + 32 * kk, 16, 1024)
            for nn in range(0, 64, 7):
                for k in range(16):
                    assert _read_bf16(raw, _desc_a_read(slot, desc, nn, k)) == \
                        skw[n0 + nn, 64 * j + 16 * kk + k]


# --------------------------------------- the plain version against the JAX kernel
def _layer(seed, h, w, c, cin, co):
    rng = np.random.RandomState(seed)

    def f(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    def pos(k):
        return (np.abs(rng.randn(k)) + 0.3).astype(np.float32)

    return dict(x=f(2, h, w, c), x_in=f(2, h, w, cin), dwk=f(3, 3, 1, c, scale=0.3),
                pwk=f(1, 1, c, co, scale=0.2), a1=pos(c), b1=f(c, scale=0.1), a2=pos(co),
                b2=f(co, scale=0.1), skw=f(1, 1, cin, co, scale=0.2), sa=pos(co),
                sb=f(co, scale=0.1))


@pytest.mark.parametrize("d", [1, 2])
def test_int8_dot_stride1_conv_skip_matches_pallas(d):
    """``_kernel_v3_skip`` with ``int8_dot`` and a stride-1 conv skip (block3's
    end at output stride 8): equal up to a depthwise value within an f32
    ulp of a half-integer rounding to the other int8, at most one int8 step
    of the output scale, plus f32 rounding of the epilogue (1e-5 of the
    largest output)."""
    t = _layer(20 + d, 16, 32, 16, 24, 16)
    ms, mb, wq, osc = js.fold_sepconv_int8(t["a1"], t["b1"], t["pwk"], t["a2"])
    args = (t["x"], t["x_in"], t["dwk"], ms, mb, wq, osc, t["b2"], t["skw"], t["sa"], t["sb"])
    kw = dict(dilation=d, stride=1, pre_relu=True, int8_dot=True, skip="conv")
    got = ts.fused_sepconv_infer_v3_skip(*[torch.from_numpy(np.array(a)) for a in args], **kw)
    want = np.asarray(js.fused_sepconv_infer_v3_skip(*args, tile_out=4, interpret=True, **kw))
    assert got.shape == want.shape == (2, 16, 32, 16)
    err = np.abs(got.numpy() - want)
    step = float(np.max(np.abs(np.asarray(wq)).max(axis=0) * np.abs(np.asarray(osc))))
    assert err.max() <= step + 1e-5 * np.abs(want).max(), err.max()
    assert (err > 1e-5 * np.abs(want).max()).mean() < 1e-3
