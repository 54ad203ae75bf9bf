"""Fused Xception entry chain: the stem, and the stem plus block1, as
hand-written CUDA kernels (``csrc/entrychain.cu``).

Replaces the Pallas kernels of ``segmentron_tpu/ops/entrychain.py``:
``fused_stem`` (``_stem_kernel``) and ``fused_stem_block1``
(``_stem_block1_kernel``), with the same arguments: NHWC images and the
JAX layouts of the weights (conv ``HWIO``, depthwise ``(3,3,1,C)``,
pointwise ``(1,1,C,C')``) with BN already folded into f32 affines
``(a, b)`` (``ops/quant.py::bn_folded_affine``). Inference only.

- ``fused_stem``: conv1 3x3 s2 3->32 +BN+ReLU, conv2 3x3 s1 32->64
  +BN+ReLU: (N,H,W,3) -> (N,H/2,W/2,64).
- ``fused_stem_block1``: the stem, then block1 (three separable convs
  64->128->128->128, dw3x3 +BN then pw1x1 +BN, no ReLU, the last dw
  stride 2) plus the 1x1 s2 conv skip +BN on the conv2 output, summed:
  (N,H,W,3) -> (N,H/4,W/4,128).

Bound on one H100 at 1024x2048, per image: stem+block1 does ~27.3 G MAC
(~54.5 GFLOP) and moves ~46 MB in bf16, so it is bound by operations
(~55 us at the dense bf16 tensor-core peak); the stem does ~10.1 G MAC
and moves ~80 MB (12.6 MB in, 67.1 MB out), so it is bound by bytes
(~24 us; in f32 by operations on the CUDA cores, ~0.30 ms).

Three designs share the source, and none stands in for another: a CUDA
tensor outside a kernel's gate raises.

- ``fused_stem`` in bf16 takes ``stem_wgmma_kernel``: persistent blocks,
  one an SM, of four warpgroups walk output tiles of 8 x 62 pixels at 1/2
  resolution. Two producer warpgroups run conv1 on ``wgmma`` (A gathered
  in registers from the image patch, which TMA loads two tiles ahead) into
  one of two c1 buffers while two consumer warpgroups run conv2 on the
  other: transposed (the 64 output channels as M), over a raster 64 wide so
  that each tap is a shift of the c1 planes, in chains of 128 pixels that
  the consumers issue in turns; each chain's epilogue writes a staging slot
  that a TMA store sends out while the next chains run. Its operands are
  ``pack_operands``' stem form (conv1, conv2); ``stem_plan`` gives the
  tile, the grid and every region. On an NVIDIA H100 80GB HBM3 at 700.00 W
  it takes 0.0472 ms at (1, 1024, 2048, 3), 0.0440 with the launch hidden,
  5.3x the first version in turns and 1.8x its bound (``chip_smoke.py
  --entry --baseline``); shared memory, which the products read and the
  gather, the epilogues and the stores also use, sets its pace
  (``--entry-probe``).
- ``fused_stem_block1`` in bf16 takes ``stem_block1_wgmma_kernel``:
  persistent blocks, one an SM, each walking output tiles of 8 x 8 pixels
  at 1/4 resolution; the products (conv1, conv2, the skip, the three
  pointwise convs) on ``wgmma`` with f32 sums, their B operands read once
  a tile and stage as bf16 by TMA from the buffer ``pack_operands`` writes
  (128-byte-swizzled K-major boxes), the image patch by a TMA tile load,
  the depthwise taps on the CUDA cores; every stage of a tile stays in
  shared memory, stages that are read and written at once overlapping
  where the reads have moved on (``entry_plan`` gives the tile, the grid
  and every region; the source's header the whole design). On an NVIDIA
  H100 80GB HBM3 at 700.00 W it takes 0.4279 ms at (1, 1024, 2048, 3),
  7.8x its bound, the depthwise taps on the CUDA cores, the epilogues and
  the stages run one after the other setting the pace (``chip_smoke.py
  --entry-probe``).
- f32 I/O of both keeps the first version: one block a tile, every stage
  f32 FMA on the CUDA cores.

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes
the plain PyTorch version (``*_plain``, the same stages as ``F.conv2d``
calls with the same casts) only for a CPU tensor. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .kernels import library

__all__ = [
    "entry_plan",
    "kernel_entry_plan",
    "kernel_stem_plan",
    "fused_stem",
    "fused_stem_plain",
    "stem_supported",
    "fused_stem_block1",
    "fused_stem_block1_plain",
    "pack_operands",
    "pack_weights",
    "stem_block1_supported",
    "stem_plan",
]

_B = 16  # the JAX kernels' W-block; kept so the gates below match theirs


def stem_supported(h: int, w: int, c: int, strip: int = 8) -> bool:
    """The JAX package's geometry gate for ``fused_stem``."""
    return (
        c == 3
        and h % 2 == 0
        and w % (2 * _B) == 0
        and strip % 2 == 0
        and (h // 2) % strip == 0
        and h // 2 >= 2 * strip
    )


def stem_block1_supported(h: int, w: int, c: int, strip: int = 4) -> bool:
    """The JAX package's geometry gate for ``fused_stem_block1``."""
    return (
        c == 3
        and h % 4 == 0
        and w % (4 * _B) == 0
        and strip % 4 == 0
        and (h // 4) % strip == 0
        and h // 4 >= 2 * strip
    )


# ------------------------------------------------------- the wgmma kernel's plan
# Mirror of csrc/entrychain.cu's constants for stem_block1_wgmma_kernel
# (``entry_plan`` there; chip_smoke.py holds the two equal on the card).
H100_SMS = 132
TILE = 8  # output pixels a side of a tile, at 1/4 resolution
# Stage extents (rows, columns) of a tile, at 1/2 resolution, and their
# origins relative to (2 t0, 2 u0), the tile's corner there: c1 (conv1),
# x2 (conv2), x3 (sep1), x4 (sep2); conv2 runs over a raster as wide as
# c1, so that a tap is a shift of its rows.
EXTENTS = {"c1": (23, 23), "x2": (21, 21), "x3": (19, 19), "x4": (17, 17)}
ORIGINS = {"c1": -4, "x2": -3, "x3": -2, "x4": -1}
# the image patch: rows, bf16 elements a row (48 pixels from 4 u0 - 9 and the
# 5 elements before them: TMA starts a row only at a 16-byte-aligned element)
IMAGE_BOX = (47, 152)
# bytes a pixel of x2, x3, x4 in shared memory: the channels and 16 (so that
# eight rows stored at one channel offset fall in eight bank groups)
PIXEL_BYTES = {"x2": 64 * 2 + 16, "x3": 128 * 2 + 16, "x4": 128 * 2 + 16}
C1_PLANE_PIXELS = 560  # c1 pixels of a channel plane: 529 and the kept rows' shifted reads
# 64-row M tiles of each product (those the three warpgroups split by rows
# rounded up to a multiple of 3, so that each takes as many)
WARPGROUPS = 3
M_TILES = {"conv1": 9, "conv2": 9, "skip": 1, "pw1": 6, "pw2": 6, "pw3": 1}
# sep1's and sep2's chunk m (64 rows of the stage it writes) writes its rows
# once the taps of chunks m - TAP_WAITS .. m - 1 are done: every chunk before
# it, whichever warpgroup runs it
TAP_WAITS = M_TILES["pw1"] - 1
# B operands of pack_operands: (name, N, K padded to 64) in the buffer's order
OPERANDS = (("conv1", 32, 64), ("conv2", 64, 320), ("skip", 128, 64), ("pw1", 128, 64),
            ("pw2", 128, 128), ("pw3", 128, 128))
SMEM_LIMIT = 232448


def _regions():
    """Byte (offset, size) of each shared-memory region, from the block's
    1024-byte-aligned base: two weight slots, two A slots, the stage area
    X (c1 and x4 at its start, x3 1904 bytes in, x2 36352 bytes after x3 to
    X's end, the image patch past x4), the f32 depthwise taps and affines,
    the mbarriers, and the products' affines as float4s of channel pairs."""
    w0, w1, a = 40960, 32768, 16384
    x = w0 + w1 + 2 * a
    x3 = x + 1904
    x2 = x3 + 36352
    prm = x2 + 21 * 21 * PIXEL_BYTES["x2"]
    return {
        "w0": (0, w0), "w1": (w0, w1), "a0": (w0 + w1, a), "a1": (w0 + w1 + a, a),
        "c1": (x, 4 * C1_PLANE_PIXELS * 16), "x4": (x, 17 * 17 * PIXEL_BYTES["x4"]),
        "x3": (x3, 19 * 19 * PIXEL_BYTES["x3"]), "x2": (x2, 21 * 21 * PIXEL_BYTES["x2"]),
        "img": (x + 78720, IMAGE_BOX[0] * IMAGE_BOX[1] * 2),
        "prm": (prm, 3520 * 4), "bar": (prm + 3520 * 4, 16 * 8),
        "aff": (prm + 3520 * 4 + 16 * 8, 1216 * 4),
    }


def entry_plan(n: int, h: int, w: int, sms: int = H100_SMS) -> dict:
    """What ``stem_block1_wgmma_kernel`` runs for a (n, h, w, 3) bf16
    image: ``tile`` (output rows, columns at 1/4 resolution), ``tiles``
    (across, down, images), ``grid`` (persistent blocks, one an SM at
    most), ``threads``, ``smem`` (dynamic bytes, 1 KB alignment slack
    included), ``regions`` (``_regions``), ``extents``, ``m_tiles``,
    ``tap_waits`` (``TAP_WAITS``).
    Raises ValueError outside ``stem_block1_supported``."""
    if n < 1 or not stem_block1_supported(h, w, 3):
        raise ValueError(f"entry_plan: no kernel takes ({n}, {h}, {w}, 3)")
    tiles = (w // 4 // TILE, -(-(h // 4) // TILE), n)
    regions = _regions()
    end = max(off + size for off, size in regions.values())
    return dict(tile=(TILE, TILE), tiles=tiles, grid=min(sms, tiles[0] * tiles[1] * n),
                threads=128 * WARPGROUPS, smem=end + 1024, regions=regions, extents=dict(EXTENTS),
                m_tiles=dict(M_TILES), tap_waits=TAP_WAITS)


def plan_ints(plan: dict) -> list:
    """``plan`` flattened in the order of the source's ``entry_plan``."""
    order = ("w0", "w1", "a0", "a1", "c1", "x4", "x3", "x2", "img", "prm", "bar", "aff")
    return [*plan["tile"], *plan["tiles"], plan["grid"], plan["threads"], plan["smem"],
            *(v for k in order for v in plan["regions"][k]),
            *(v for k in ("c1", "x2", "x3", "x4") for v in plan["extents"][k]),
            *(plan["m_tiles"][k] for k in ("conv1", "conv2", "skip", "pw1", "pw2", "pw3")),
            plan["tap_waits"]]


# ---------------------------------------------------- the stem kernel's plan
# Mirror of csrc/entrychain.cu's constants for stem_wgmma_kernel
# (``stem_plan`` there; chip_smoke.py holds the two equal on the card).
STEM_TILE = (8, 62)  # output rows, columns of a tile at 1/2 resolution
STEM_RASTER = 64  # conv2's raster and c1's width: a raster row is one M tile
STEM_C1_ROWS = STEM_TILE[0] + 2
STEM_PLANE_PIXELS = 648  # c1 pixels of a channel plane: 640 and the spare columns' reads
STEM_CHAIN_N = 128  # raster pixels of a conv2 chain (two output rows)
STEM_CHAINS = STEM_TILE[0] * STEM_RASTER // STEM_CHAIN_N  # 4: two for each consumer
# the patch as a box of the image seen as (n, h, 3 w / 8, 8): rows, 16-byte
# chunks (400 elements: the row's lead to a chunk start, then 64 c1 columns'
# taps, 6 elements a column)
STEM_IMAGE_BOX = (2 * STEM_C1_ROWS + 1, 50)
STEM_WARPGROUPS = 4  # two producers (conv1) and two consumers (conv2)


def _stem_regions():
    """Byte (offset, size) of each shared-memory region of
    ``stem_wgmma_kernel`` from the block's 1024-byte-aligned base: conv2's
    A (the weights as ``pack_operands`` lays out conv2's B) and conv1's B,
    the staging slots (one for each of a tile's conv2 chains, two output
    rows of 64 pixels x 128 bytes each), the two c1 buffers (four planes of
    8 channels each), the two patches, the f32 affines (a1, b1, a2, b2),
    the mbarriers."""
    slot = 2 * STEM_RASTER * 128
    c1 = 4 * STEM_PLANE_PIXELS * 16
    w2, w1 = 64 * 320 * 2, 32 * 64 * 2
    stage = w2 + w1
    c1_off = stage + STEM_CHAINS * slot
    img = c1_off + 2 * c1
    raw = img + 2 * 17408
    return {
        "w2": (0, w2), "w1": (w2, w1), "stage": (stage, c1_off - stage), "c1": (c1_off, 2 * c1),
        "img": (img, 2 * 17408), "raw": (raw, (64 + 128) * 4), "bar": (raw + 768, 7 * 8),
    }


def stem_plan(n: int, h: int, w: int, sms: int = H100_SMS) -> dict:
    """What ``stem_wgmma_kernel`` runs for a (n, h, w, 3) bf16 image:
    ``tile`` (output rows, columns at 1/2 resolution), ``raster``,
    ``tiles`` (across, down, images), ``grid`` (persistent blocks, one an
    SM at most), ``threads``, ``smem`` (dynamic bytes, 1 KB alignment slack
    included), ``regions`` (``_stem_regions``), ``c1`` (rows, pixels a
    plane), ``conv1_m_tiles``, ``chains`` (conv2's chains a tile and their
    N), ``image_box`` (rows, chunks), ``out_box`` (pixels a row),
    ``slot`` (bytes a staging slot).
    Raises ValueError outside ``stem_supported``."""
    if n < 1 or not stem_supported(h, w, 3):
        raise ValueError(f"stem_plan: no kernel takes ({n}, {h}, {w}, 3)")
    tiles = (-(-(w // 2) // STEM_TILE[1]), h // 2 // STEM_TILE[0], n)
    regions = _stem_regions()
    end = max(off + size for off, size in regions.values())
    return dict(tile=STEM_TILE, raster=STEM_RASTER, tiles=tiles,
                grid=min(sms, tiles[0] * tiles[1] * n), threads=128 * STEM_WARPGROUPS,
                smem=end + 1024, regions=regions, c1=(STEM_C1_ROWS, STEM_PLANE_PIXELS),
                conv1_m_tiles=STEM_C1_ROWS * STEM_RASTER // 64,
                chains=(STEM_CHAINS, STEM_CHAIN_N), image_box=STEM_IMAGE_BOX,
                out_box=STEM_TILE[1], slot=2 * STEM_RASTER * 128)


def stem_plan_ints(plan: dict) -> list:
    """``plan`` (``stem_plan``) flattened in the order of the source's
    ``stem_plan``."""
    order = ("w2", "w1", "stage", "c1", "img", "raw", "bar")
    return [*plan["tile"], plan["raster"], *plan["tiles"], plan["grid"], plan["threads"],
            plan["smem"], *(v for k in order for v in plan["regions"][k]), *plan["c1"],
            plan["conv1_m_tiles"], *plan["chains"], *plan["image_box"], plan["out_box"],
            plan["slot"]]


def _swizzled(b, k_pad):
    """The B operand of a product with weights ``b`` (K, N) as wgmma reads
    it K-major: N rows of K bf16, K zero-padded to ``k_pad``, in boxes of 64
    columns ([N][64], 128 bytes a row); in each box the 16-byte chunk c of
    row r lies at chunk c ^ (r % 8) (the 128-byte swizzle)."""
    k, n = b.shape
    bt = torch.zeros(n, k_pad, dtype=b.dtype, device=b.device)
    bt[:, :k] = b.t()
    boxes = bt.view(n, k_pad // 64, 8, 8).permute(1, 0, 2, 3)
    rows = torch.arange(n, device=b.device)[:, None]
    out = torch.empty_like(boxes)
    out[:, rows, torch.arange(8, device=b.device)[None, :] ^ (rows % 8)] = boxes
    return out.reshape(-1)


def pack_operands(x, stem_p, sep_p=(), skip_p=()):
    """The bf16 B operands of ``stem_block1_wgmma_kernel``'s products on
    ``x``'s device, each rounded to bf16 (the plain version's casts), in
    the order and layout of ``OPERANDS``: conv1 (K = 27 taps, ky kx ci,
    padded to 64), conv2 (K = 288 = 9 taps x 32 channels, padded to 320),
    the skip, pw1, pw2, pw3. The kernel copies each into a weight slot as
    it is. Without ``sep_p`` and ``skip_p``, the stem's form: conv1 and
    conv2 alone, what ``stem_wgmma_kernel`` reads (conv2's as its A). A
    caller packs once per weight set (``packed=``)."""
    k1, k2 = stem_p[0], stem_p[3]
    mats = (k1.reshape(27, 32), k2.reshape(288, 64))
    if sep_p:
        mats += (skip_p[0].reshape(64, 128),
                 *(p[3].reshape(p[3].shape[2], p[3].shape[3]) for p in sep_p))
    return torch.cat([_swizzled(m.to(x.device, torch.bfloat16), kp)
                      for m, (_, _, kp) in zip(mats, OPERANDS)])


# ------------------------------------------------------------ plain versions
def _conv(y, k, dt, stride, pad, groups=1):
    """f32 conv of ``y`` (f32 holding values of ``dt``) with the HWIO
    kernel ``k`` rounded to ``dt``: products exact, sums in f32."""
    w = k.to(dt).float().permute(3, 2, 0, 1)
    return F.conv2d(y, w, stride=stride, padding=pad, groups=groups)


def _affine(y, a, b, dt, relu=False):
    """f32 affine (and ReLU) of an f32 sum, rounded to ``dt`` and kept
    in f32 for the next stage."""
    y = y * a.float().view(1, -1, 1, 1) + b.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(dt).float()


def _stem_nchw(x, k1, a1, b1, k2, a2, b2):
    dt = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    y = _affine(_conv(y, k1, dt, 2, 1), a1, b1, dt, relu=True)
    return _affine(_conv(y, k2, dt, 1, 1), a2, b2, dt, relu=True)


def fused_stem_plain(x, k1, a1, b1, k2, a2, b2):
    """Plain PyTorch version of ``fused_stem``."""
    y = _stem_nchw(x, k1, a1, b1, k2, a2, b2)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def fused_stem_block1_plain(x, stem_p, sep_p, skip_p):
    """Plain PyTorch version of ``fused_stem_block1``: every stage
    rounded to the input dtype, sums in f32."""
    dt = x.dtype
    inp = _stem_nchw(x, *stem_p)
    y = inp
    for i, (dwk, ad, bd, pwk, ap, bp) in enumerate(sep_p):
        y = _affine(_conv(y, dwk, dt, 2 if i == 2 else 1, 1, groups=y.shape[1]),
                    ad, bd, dt)
        y = _affine(_conv(y, pwk, dt, 1, 0), ap, bp, dt)
    wsk, a_s, b_s = skip_p
    sk = _affine(_conv(inp, wsk, dt, 2, 0), a_s, b_s, dt)
    return (y + sk).to(dt).permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------------ kernels
_counts = {}  # id of a loaded library -> (its param counts, its operand counts)


def _lib():
    lib = library("entrychain")
    if id(lib) in _counts:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.entry_stem.argtypes = lib.entry_stem_block1.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.entry_stem.restype = lib.entry_stem_block1.restype = i
    lib.entry_param_count.argtypes = [i]
    lib.entry_param_count.restype = i
    lib.entry_operand_count.argtypes = [i]
    lib.entry_operand_count.restype = i
    lib.entry_plan.argtypes = lib.stem_plan.argtypes = [i, i, i, i, p]
    lib.entry_plan.restype = lib.stem_plan.restype = i
    _counts[id(lib)] = ((lib.entry_param_count(0), lib.entry_param_count(1)),
                        (lib.entry_operand_count(0), lib.entry_operand_count(1)))
    return lib


def kernel_entry_plan(n, h, w, sms=0):
    """``entry_plan`` as the compiled source reports it (needs ``nvcc``),
    flattened as ``plan_ints``; ``sms`` <= 0: the current device's."""
    out = (ctypes.c_int * 47)()
    rc = _lib().entry_plan(n, h, w, sms, out)
    if rc != 0:
        raise ValueError(f"entry_plan: rc {rc}")
    return list(out)


def kernel_stem_plan(n, h, w, sms=0):
    """``stem_plan`` as the compiled source reports it (needs ``nvcc``),
    flattened as ``stem_plan_ints``; ``sms`` <= 0: the current device's."""
    out = (ctypes.c_int * 32)()
    rc = _lib().stem_plan(n, h, w, sms, out)
    if rc != 0:
        raise ValueError(f"stem_plan: rc {rc}")
    return list(out)


def pack_weights(x, stem_p, sep_p=(), skip_p=()):
    """The kernels' weight buffer for input ``x``: all weights as one f32
    buffer on ``x``'s device, in the order ``csrc/entrychain.cu`` reads
    them; conv weights rounded to ``x.dtype`` (the plain version's
    casts), affines f32. A caller that runs the same weights many times
    packs them once and passes ``packed=`` to the wrappers."""
    pieces = []
    for t, is_weight in _kernel_order(stem_p, sep_p, skip_p):
        t = t.to(x.device, x.dtype) if is_weight else t.to(x.device)
        pieces.append(t.float().reshape(-1))
    return torch.cat(pieces)


def _kernel_order(stem_p, sep_p, skip_p):
    """(tensor, is a conv weight) in the order the kernel reads them:
    every conv's weight followed by its affine ``a`` and ``b``."""
    groups = [stem_p[:3], stem_p[3:]]
    for p in sep_p:
        groups += [p[:3], p[3:]]
    if skip_p:
        groups.append(skip_p)
    return [(t, j == 0) for g in groups for j, t in enumerate(g)]


def _check(x, name, mult):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"{name}: expected (N, H, W, 3), got {tuple(x.shape)}")
    n, h, w, _ = x.shape
    if h % mult or w % mult:
        raise ValueError(f"{name}: H and W must be multiples of {mult}, got {h}x{w}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous NHWC")


def _launch(entry, block1, x, prm, out, ops=None):
    """Launch ``entry`` on ``x`` with the f32 buffer ``prm`` and, in bf16,
    the operand buffer ``ops``."""
    if prm.device != x.device or prm.dtype != torch.float32:
        raise ValueError(f"packed weights: {prm.dtype} on {prm.device}, input on {x.device}")
    lib = _lib()
    params, operands = _counts[id(lib)]
    want = params[int(block1)]
    if prm.numel() != want:
        raise ValueError(f"packed parameters: {prm.numel()} floats, kernel reads {want}")
    n, h, w, _ = x.shape
    wgmma = x.dtype == torch.bfloat16
    if wgmma:
        supported = stem_block1_supported if block1 else stem_supported
        if not supported(h, w, 3):
            raise ValueError(f"{entry}: ({n}, {h}, {w}, 3) is outside the kernel's gate")
        want = operands[int(block1)]
        if (ops is None or ops.device != x.device or ops.dtype != torch.bfloat16
                or ops.numel() != want):
            raise ValueError(f"packed operands: want {want} bf16 on {x.device}")
    bufs = (x.data_ptr(), out.data_ptr(), prm.data_ptr(), ops.data_ptr() if wgmma else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(*bufs, n, h, w, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def fused_stem(x, k1, a1, b1, k2, a2, b2, packed=None):
    """Fused stem: (N, H, W, 3) -> (N, H/2, W/2, 64). ``packed``: the
    ``pack_weights`` buffer of these weights for ``x``, or the pair (that
    buffer, their ``pack_operands`` buffer in the stem's form), or None.
    bf16 reads both; given the first alone it packs the second."""
    if x.device.type == "cpu":
        return fused_stem_plain(x, k1, a1, b1, k2, a2, b2)
    _check(x, "fused_stem", 2)
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 2, w // 2, 64), dtype=x.dtype, device=x.device)
    stem_p = (k1, a1, b1, k2, a2, b2)
    prm, ops = packed if isinstance(packed, tuple) else (packed, None)
    if prm is None:
        prm = pack_weights(x, stem_p)
    if ops is None and x.dtype == torch.bfloat16:
        ops = pack_operands(x, stem_p)
    _launch("entry_stem", False, x, prm, out, ops)
    fused_stem.launches += 1
    return out


def fused_stem_block1(x, stem_p, sep_p, skip_p, packed=None):
    """Fused stem + block1: (N, H, W, 3) -> (N, H/4, W/4, 128).

    ``stem_p`` = (k1, a1, b1, k2, a2, b2); ``sep_p`` = three tuples
    (dw (3,3,1,C), a_dw, b_dw, pw (1,1,C,C'), a_pw, b_pw); ``skip_p`` =
    (wsk (1,1,64,128), a, b); ``packed``: their ``pack_weights`` buffer
    for ``x``, or the pair (that buffer, their ``pack_operands`` buffer),
    or None. bf16 reads both; given the first alone it packs the second."""
    if x.device.type == "cpu":
        return fused_stem_block1_plain(x, stem_p, sep_p, skip_p)
    _check(x, "fused_stem_block1", 4)
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 4, w // 4, 128), dtype=x.dtype, device=x.device)
    prm, ops = packed if isinstance(packed, tuple) else (packed, None)
    if prm is None:
        prm = pack_weights(x, stem_p, sep_p, skip_p)
    if ops is None and x.dtype == torch.bfloat16:
        ops = pack_operands(x, stem_p, sep_p, skip_p)
    _launch("entry_stem_block1", True, x, prm, out, ops)
    fused_stem_block1.launches += 1
    return out


fused_stem.launches = 0
fused_stem_block1.launches = 0
