"""The fused separable conv's routing on the CPU (``csrc/sepconv.cu``,
``ops/sepconv.py``): the host's choice of kernel, tiles, grid, Co split and
shared memory through its Python mirror ``sepconv_plan`` at every
``chip_smoke.py`` case and every fused layer of the flagship, and the
wgmma kernel's index arithmetic, emulated: the quads of pixels its threads
take, the 128-byte swizzle of the A tile its taps write and of the
staging its epilogue writes and reads. ``chip_smoke.py`` holds the mirror equal to
the source's own ``sepconv_plan`` on the card.

The wgmma kernel sums each output's nine taps in the order of the older
kernels and of ``_sepconv_plain`` ((ky, kx), one fused multiply-add a tap)
and rounds the mid affine's product and sum separately, so its arithmetic
is that of the kernel ``tests/test_torch_sepconv.py`` already holds to the
JAX package; the emulation here checks where each value lands."""

import numpy as np
import pytest
import torch

from chip_smoke import FLAGSHIP_SEPCONV_LAYERS, SEPCONV_CASES
from segmentron_tpu_torch.ops.sepconv import MAX_SMEM, sepconv_plan

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100


def _plan(fn, shape, co, d, stride=1, skip=None, int8=False, dtype=torch.bfloat16, cin=128):
    """The mirror's plan; ``cin`` is read for the conv skip only (the
    flagship's are 128 and 256: the plan reads it only through cin % 8)."""
    n, h, w, c = shape
    return sepconv_plan(n, h, w, c, co, d, stride, skip, dtype, int8,
                        cin=cin if skip == "conv" else 0)


def _takes_wgmma(stride, skip, dtype, d, c, co, cin=128):
    return (dtype == torch.bfloat16 and stride == 1 and d in (1, 2) and c % 8 == 0
            and co % 8 == 0 and (skip != "conv" or cin % 8 == 0))


@pytest.mark.parametrize("case", SEPCONV_CASES,
                         ids=lambda c: f"{c['fn'].replace('fused_sepconv_infer', 'f')}-"
                                       f"{'x'.join(map(str, c['shape'][1:]))}-d{c['d']}"
                                       f"-s{c.get('stride', 1)}-{c.get('skip')}-{c['int8']}")
def test_case_routes(case):
    """bf16 at stride 1 takes the wgmma kernel, with or without skip (every
    main case among them); f32 and stride 2 keep the older kernels' routes;
    all fit the card's shared memory."""
    stride, skip, cin = case.get("stride", 1), case.get("skip"), case.get("cin", 128)
    for dt in (torch.float32, torch.bfloat16):
        p = _plan(case["fn"], case["shape"], case["co"], case["d"], stride, skip, case["int8"], dt,
                  cin)
        want = _takes_wgmma(stride, skip, dt, case["d"], case["shape"][3], case["co"], cin)
        assert (p["kernel"] == "wgmma") == want, (dt, p)
        assert p["smem"] <= SMEM_LIMIT == MAX_SMEM
        n, h, w, _ = case["shape"]
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        th, tw = p["tile"]
        tiles = -(-ho // th) * -(-wo // tw)
        assert p["co_split"] * p["co_block"] >= case["co"]  # the Co split covers Co
        if want:  # persistent: one block an SM, walking (Co block, tile, image)
            assert p["co_block"] == 2 * p["n_wg"] and 2 <= p["stages"] <= 4
            assert p["in_stages"] in (2, 3)
            assert p["grid"] == (min(p["co_split"] * tiles * n, 132), 1, 1)
        else:
            assert p["grid"] == (p["co_split"], tiles, n)


def test_main_cases_plan():
    """The two main cases, reckoned by hand: 8 x 8 pixels by 384 output
    channels a block (two warpgroups of m64n192), K steps of 128 bytes."""
    v3 = _plan("v3", (1, 128, 256, 728), 728, 2, int8=True)
    # 1024 + 3 A slots of 8 KB + 2 slots of the out affine of 384 channels +
    # 144 B of barriers + 2 input stages (a box of 12 x 12 x 128 bf16 and
    # 11 x 128 f32 depthwise weights), then two weight stages of 384 rows x
    # 128 bytes; 1024 items (2 Co blocks x 512 tiles) on 132 blocks
    assert v3 == dict(kernel="wgmma", tile=(8, 8), grid=(132, 1, 1), co_split=2, co_block=384,
                      n_wg=192, stages=2, in_stages=2,
                      smem=1024 + 24576 + 6144 + 144 + 2 * (36864 + 5632) + 2 * 49152)
    # d = 1, 64 channels a step: three weight stages, and room for a third
    # input stage (10 x 10 x 64 bf16 and 11 x 64 f32)
    v2 = _plan("v2", (1, 64, 128, 728), 728, 1)
    assert v2 == dict(kernel="wgmma", tile=(8, 8), grid=(132, 1, 1), co_split=2, co_block=384,
                      n_wg=192, stages=3, in_stages=3,
                      smem=1024 + 24576 + 6144 + 144 + 3 * (12800 + 2816) + 3 * 49152)
    # the exit flow's 1536 -> 2048: 128 columns a warpgroup, eight Co blocks
    exit_ = _plan("v2", (1, 64, 128, 1536), 2048, 2)
    assert (exit_["kernel"], exit_["n_wg"], exit_["co_split"]) == ("wgmma", 128, 8)


def test_old_routes_unchanged():
    """The sum-skip block end on the wgmma kernel, and f32 and stride 2 as
    the older kernels' launch picked them, reckoned by hand from its tiles
    (8 x 16 pixels, 32-channel chunks, 128-channel Co tiles)."""
    # sum-skip block end, int8: the v3 main case's plan (test_main_cases_plan)
    # and two x_in boxes of 8 KB with their four barriers; two weight stages
    p = _plan("v3_skip", (1, 128, 256, 728), 728, 2, skip="sum", int8=True)
    assert p == dict(kernel="wgmma", tile=(8, 8), grid=(132, 1, 1), co_split=2, co_block=384,
                     n_wg=192, stages=2, in_stages=2,
                     smem=1024 + 24576 + 6144 + 144 + (16384 + 32) + 2 * (36864 + 5632)
                     + 2 * 49152)
    # f32 products: the recompute kernel, one Co tile a block
    p = _plan("v2", (1, 64, 128, 728), 728, 1, dtype=torch.float32)
    assert (p["kernel"], p["grid"], p["co_block"]) == ("recompute", (6, 64, 1), 128)
    assert p["smem"] == 18432 + 16384 + 10 * 18 * 32 * 4
    # stride 2 with the conv skip's stash (64 KB)
    p = _plan("v3_skip", (1, 256, 512, 256), 256, 1, 2, "conv", True)
    assert p["kernel"] == "resident" and p["grid"] == (1, 256, 1)
    assert p["smem"] == 128 * 272 + max(2 * 17 * 33 * 32 * 2, 49152) + 65536


def test_wgmma_gate():
    """What the wgmma kernel does not take keeps the older kernels' routes: dilations
    other than 1 and 2, channels that are not 16-byte rows, f32."""
    base = dict(shape=(1, 64, 128, 728), co=728)
    assert _plan("v2", **base, d=3)["kernel"] != "wgmma"
    assert _plan("v2", (1, 64, 128, 724), 728, 1)["kernel"] != "wgmma"
    assert _plan("v2", (1, 64, 128, 728), 724, 1)["kernel"] != "wgmma"
    assert _plan("v2", **base, d=1, dtype=torch.float32)["kernel"] != "wgmma"
    assert _plan("v2", **base, d=4)["kernel"] != "wgmma"
    for d in (1, 2, 4):
        for int8 in (False, True):
            p = _plan("v3", (1, 128, 256, 728), 728, d, int8=int8)
            assert p["smem"] <= SMEM_LIMIT and (p["kernel"] == "wgmma") == (d < 4)
    with pytest.raises(ValueError):
        _plan("v2", (1, 64, 128, 728), 728, 1, stride=2, skip="sum")


def test_flagship_layer_routes():
    """Every fused layer of paths A and B: v2, v3 and the stride-1 block
    ends take the wgmma kernel, block2's stride-2 end keeps the resident
    kernel; 55 v2, 36 v3 and 18 v3_skip launches a forward with the entry
    kernel on."""
    counts = {}
    for fn, shape, co, d, stride, skip, int8, n in FLAGSHIP_SEPCONV_LAYERS:
        p = _plan(fn, shape, co, d, stride, skip, int8)
        assert p["kernel"] == ("resident" if stride == 2 else "wgmma"), (fn, shape)
        assert p["smem"] <= SMEM_LIMIT
        if not (fn.endswith("v2") and shape[1] == 512):  # block1: the entry kernel's
            counts[fn] = counts.get(fn, 0) + n
    assert counts == {"fused_sepconv_infer_v2": 55, "fused_sepconv_infer_v3": 36,
                      "fused_sepconv_infer_v3_skip": 18}


def test_flagship_layers_are_a_forwards(monkeypatch):
    """FLAGSHIP_SEPCONV_LAYERS is what a forward of the flagship at
    1024 x 2048 launches on paths A and B: the model moved to the meta
    device, the fused entry points replaced by recorders."""
    import segmentron_tpu_torch.models.backbones.xception as xception
    import segmentron_tpu_torch.modules.basic as basic
    from chip_smoke import PATH_A, PATH_B, reset_cfg
    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.models import get_segmentation_model
    from segmentron_tpu_torch.modules import SepconvRoutes

    calls = {}

    def recorder(name):
        def record(x, *args, **kw):
            n, h, w, c = x.shape
            pw = args[4] if name.endswith("skip") else args[3]
            co, s = pw.reshape(c, -1).shape[1], kw.get("stride", 1)
            key = (name, tuple(x.shape), co, kw["dilation"], s, kw.get("skip"),
                   bool(kw.get("int8_dot", False)))
            calls[key] = calls.get(key, 0) + 1
            return torch.empty((n, (h - 1) // s + 1, (w - 1) // s + 1, co), device=x.device)
        return record

    for module, name in ((basic, "fused_sepconv_infer_v2"), (basic, "fused_sepconv_infer_v3"),
                         (xception, "fused_sepconv_infer_v3_skip")):
        monkeypatch.setattr(module, name, recorder(name))
    defaults = cfg.to_dict()
    try:
        cfg.update_from_file("configs/cityscapes_deeplabv3_plus_xception65.yaml")
        cfg.update_from_list(["DATASET.NAME", "synthetic"])
        for opts in (PATH_A, ["TPU.USE_PALLAS_SEPCONV", "False"] + PATH_B):
            cfg.update_from_list(opts)
            with torch.device("meta"):  # shapes only: no weights are made
                model = get_segmentation_model(torch.device("meta")).eval()
            routes = SepconvRoutes.from_cfg(cfg)
            for m in model.modules():
                if hasattr(m, "routes"):
                    m.routes = routes
            model.backbone.fused_stem = False  # block1's convs too
            with torch.inference_mode():
                model(torch.empty(1, 1024, 2048, 3, device="meta"))
    finally:
        reset_cfg(cfg, defaults)
    assert calls == {tuple(layer[:7]): layer[7] for layer in FLAGSHIP_SEPCONV_LAYERS}


# ------------------------------------------------ the kernel's index arithmetic
def _quad_rows(q, d):
    """wg_depthwise's quad q (0..3 down or across): its two rows (or
    columns) d apart."""
    base = (q // d) * 2 * d + q % d
    return base, base + d


@pytest.mark.parametrize("d", [1, 2])
def test_quads_tile_the_block(d):
    """The 16 quads of 2 x 2 pixels d apart cover the 8 x 8 pixels once,
    and read only inside the (8 + 2d)^2 haloed box."""
    seen = np.zeros((8, 8), dtype=int)
    for quad in range(16):
        rows, cols = _quad_rows(quad // 4, d), _quad_rows(quad % 4, d)
        for r in rows:
            for c in cols:
                seen[r, c] += 1
        # input rows rb + m d, m < 4, of the box that starts d before the tile
        assert rows[0] + 3 * d < 8 + 2 * d and cols[0] + 3 * d < 8 + 2 * d
    assert (seen == 1).all()


def _swizzle(row, byte):
    """Byte offset of byte ``byte`` of row ``row`` in a 128-byte-swizzled
    tile: 16-byte chunk c lands at chunk c ^ (row % 8)."""
    return row * 128 + ((((byte // 16) ^ row) & 7) << 4) + byte % 16


@pytest.mark.parametrize("d,int8", [(1, False), (2, True), (1, True)])
def test_taps_emulated_fill_the_a_tile(d, int8):
    """wg_depthwise emulated thread by thread (the same quads, the same
    channel vectors, the same tap order, fmaf as a product and a sum in
    float64 rounded once to f32, the swizzled stores): the A tile,
    unswizzled, is the depthwise conv + mid affine of the box, rounded to
    bf16 or int8, row by pixel."""
    rng = np.random.default_rng(d + 10 * int8)
    kc = 128 if int8 else 64
    kvecs, consumers = kc // 4, 256
    side = 8 + 2 * d
    box = torch.from_numpy(rng.standard_normal((side, side, kc)).astype(np.float32))
    box = torch.relu(box.to(torch.bfloat16).float())  # the loaded values, ReLU once
    w = torch.from_numpy(rng.standard_normal((9, kc)).astype(np.float32)) * 0.3
    ms = torch.from_numpy(rng.uniform(0.5, 1.5, kc).astype(np.float32)) * (20 if int8 else 1)
    mb = torch.from_numpy(rng.standard_normal(kc).astype(np.float32)) * 0.1
    a = np.zeros(64 * 128, dtype=np.uint8)
    for t in range(consumers):
        v = t % kvecs
        ch = slice(4 * v, 4 * v + 4)
        for quad in range(t // kvecs, 16, consumers // kvecs):
            rows, cols = _quad_rows(quad // 4, d), _quad_rows(quad % 4, d)
            for jj, r in enumerate(rows):
                for ii, c in enumerate(cols):
                    acc = torch.zeros(4, dtype=torch.float32)
                    for ky in range(3):
                        for kx in range(3):
                            x = box[rows[0] + (jj + ky) * d, cols[0] + (ii + kx) * d, ch]
                            acc = (acc.double() + x.double() * w[ky * 3 + kx, ch].double()).float()
                    y = (acc * ms[ch]).float() + mb[ch]
                    m = r * 8 + c
                    if int8:
                        vals = torch.clamp(torch.round(y), -127, 127).to(torch.int8).numpy()
                        raw, off = vals.view(np.uint8), 4 * v
                    else:
                        raw = y.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8)
                        off = 8 * v
                    for b, byte in enumerate(raw):
                        a[_swizzle(m, off + b)] = byte
    logical = np.array([[a[_swizzle(m, b)] for b in range(128)] for m in range(64)], np.uint8)
    taps = w.t().reshape(kc, 1, 3, 3)
    ref = torch.nn.functional.conv2d(box.permute(2, 0, 1)[None], taps, dilation=d, groups=kc)
    ref = ref[0].permute(1, 2, 0).reshape(64, kc) * ms + mb
    if int8:
        got = torch.from_numpy(logical.view(np.int8).astype(np.float32))
        want = torch.clamp(torch.round(ref), -127, 127)
        assert (got - want).abs().max() <= 1  # a sum within an ulp of a half rounds either way
        assert (got != want).float().mean() < 0.01
    else:
        got = torch.from_numpy(logical.view(np.int16).copy()).view(torch.bfloat16).float()
        assert torch.allclose(got, ref.to(torch.bfloat16).float(), rtol=2 ** -7, atol=1e-6)


def test_epilogue_staging_lands_each_fragment():
    """The epilogue's stores of the m64nN fragment (row 16 w + g (+8),
    columns 8 j + 2 q (+1)) into boxes of [64 pixels][64 channels],
    128-byte swizzled, one box of 64 columns at a time: read back by the
    same swizzle, a pixel's 16-byte chunk c at chunk c ^ (pixel % 8),
    every (pixel, channel) of the warpgroup's N columns is written once, in
    its place."""
    n = 192
    owner = {}
    for t in range(128):
        warp, lane = t // 32, t % 32
        g, q, row = lane // 4, lane % 4, (t // 32) * 16 + lane // 4
        for j in range(n // 8):
            box, chunk = j // 8, j % 8
            for r in (row, row + 8):
                for e in range(2):  # the two channels of the bf16 pair
                    phys = box * 8192 + r * 128 + ((chunk ^ g) << 4) + 4 * q + 2 * e
                    owner[phys] = (r, 8 * j + 2 * q + e)
    assert len(owner) == 64 * n
    for (r, col) in owner.values():
        box, within = col // 64, col % 64
        assert (box * 8192 + _swizzle(r, 2 * within)) in owner
        assert owner[box * 8192 + _swizzle(r, 2 * within)] == (r, col)
