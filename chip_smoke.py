#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``segmentron_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--kernels-only | --probe]

Phases, each fatal on failure (exit code != 0, no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA source under ``segmentron_tpu_torch/csrc`` with
   ``nvcc``, all started together;
3. kernels: each hand-written kernel against its plain PyTorch version
   at the shapes the full-width model gives it, in f32 (TF32 off) and
   bf16, with the stated tolerances; times by CUDA events (median of 20
   after warm-up) beside the bound the card sets for the same work. The
   entry chain at (1, 1024, 2048, 3); the fused separable conv
   (``ops/sepconv.py``, four entry points) at the flagship's layers: a
   728-channel middle-flow layer with dilation 2 and its sum-skip block
   end (output stride 8, ``int8_dot``), the stride-2 conv-skip end of
   block2 at 256x512, block3's conv-skip end, a 128-channel layer, the
   output-stride-16 middle layer, a decoder layer and a 1536-channel
   exit-flow layer (bf16 / f32 products). ``--kernels-only`` stops here;
4. model: DeepLabv3+ / Xception-65 (16 middle blocks, 19 classes) from
   the flagship YAML with random weights from a seed, in f32 (TF32
   off). Output stride 16: the fused entry routes ("block1", "stem")
   and path A (``TPU.USE_PALLAS_SEPCONV``) against the plain modules,
   logits on a small input and argmax at full width (>= 0.995). Output
   stride 8: path B (``TPU.INT8_ACTIVATIONS="pw"`` with
   ``FUSED_SEPCONV_V3`` and ``FUSED_ENTRY_V3="block2,block3"``), the
   fused kernel chains against the unfused int8 route, each held to the
   f32 model;
5. main paths, bf16, each through the ``Evaluator`` over synthetic
   1024x2048 uint8 images with every kernel launch counter set to 0
   before it and read after it: the default configuration, path A and
   path B, the counts held to what the port's gates admit for the
   layers' shapes; the ``TPU.FUSED_STEM="stem"`` route's launches;
   forward times of A, B and their unfused twins in turns; each bf16
   route's argmax against its f32 reference, no further from it than
   its unfused twin; profiler breakdowns of one forward of the default
   path and of path B (written to ``OUT_DIR``).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.

``--probe`` does none of this: it builds ``csrc/sepconv.cu`` with its
clock64 probe and prints, for each main sepconv case in bf16, the share
of a block's cycles that the taps, the products and the epilogue take.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
PATH_A = ["TPU.USE_PALLAS_SEPCONV", "True"]
PATH_B = ["MODEL.OUTPUT_STRIDE", "8", "TPU.INT8_ACTIVATIONS", "pw",
          "TPU.FUSED_SEPCONV_V3", "True", "TPU.FUSED_ENTRY_V3", "block2,block3"]
SHAPE = (1, 1024, 2048, 3)
# H100 SXM dense peaks; f32 on the CUDA cores
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
OUT_DIR = "chiprun_out"
SEPCONV_SOURCE = "segmentron_tpu_torch/csrc/sepconv.cu"
ENTRY_SOURCE = "segmentron_tpu_torch/csrc/entrychain.cu"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def median_ms(torch, fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dtype_name(dt):
    return str(dt).split(".")[-1]


# ---------------------------------------------------------------- entry chain
def entry_params(torch, gen, device):
    """Random folded weights for the entry kernels, from ``gen``."""
    def randn(*s, scale):
        return (torch.randn(*s, generator=gen) * scale).to(device)

    def pos(n):
        return (torch.rand(n, generator=gen) + 0.5).to(device)

    def sep(cin, cout):
        return (randn(3, 3, 1, cin, scale=0.2), pos(cin), randn(cin, scale=0.3),
                randn(1, 1, cin, cout, scale=0.1), pos(cout), randn(cout, scale=0.3))

    stem = (randn(3, 3, 3, 32, scale=0.2), pos(32), randn(32, scale=0.3),
            randn(3, 3, 32, 64, scale=0.1), pos(64), randn(64, scale=0.3))
    seps = (sep(64, 128), sep(128, 128), sep(128, 128))
    skip = (randn(1, 1, 64, 128, scale=0.1), pos(128), randn(128, scale=0.3))
    return stem, seps, skip


def entry_work(h, w, block1):
    """(multiply-adds, output channels, output stride) of the entry
    chain on an h x w image, counted from its shapes."""
    p2, p4 = (h // 2) * (w // 2), (h // 4) * (w // 4)
    macs = p2 * 32 * 27 + p2 * 64 * 288  # conv1, conv2
    if not block1:
        return macs, 64, 2
    macs += p2 * 64 * 9 + p2 * 64 * 128  # sep1 dw, pw
    macs += p2 * 128 * 9 + p2 * 128 * 128  # sep2
    macs += p4 * 128 * 9 + p4 * 128 * 128  # sep3 (stride 2)
    macs += p4 * 64 * 128  # skip
    return macs, 128, 4


def entry_bound(n, h, w, block1, dname, itemsize):
    """(ms, 'bytes' | 'operations'): the least time the card could take,
    each input read once and each output written once."""
    macs, cout, stride = entry_work(h, w, block1)
    nbytes = (n * h * w * 3 + n * (h // stride) * (w // stride) * cout) * itemsize
    t_ops = 2 * n * macs / PEAK_OPS[dname]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_entry_kernels(torch, entrychain, card, dev, gen):
    stem_p, sep_p, skip_p = entry_params(torch, gen, dev)
    n, h, w, _ = SHAPE
    x32 = torch.randn(SHAPE, generator=gen).to(dev)
    kernels = {
        "fused_stem_block1": dict(
            block1=True, wrapper=entrychain.fused_stem_block1,
            plain=lambda x: entrychain.fused_stem_block1_plain(x, stem_p, sep_p, skip_p),
            kernel=lambda x: entrychain.fused_stem_block1(x, stem_p, sep_p, skip_p),
            launch=("entry_stem_block1", (stem_p, sep_p, skip_p)),
            replaces="segmentron_tpu/ops/entrychain.py:386 (_stem_block1_kernel; "
                     "fused_stem_block1 :509, pallas_call :583)",
        ),
        "fused_stem": dict(
            block1=False, wrapper=entrychain.fused_stem,
            plain=lambda x: entrychain.fused_stem_plain(x, *stem_p),
            kernel=lambda x: entrychain.fused_stem(x, *stem_p),
            launch=("entry_stem", (stem_p,)),
            replaces="segmentron_tpu/ops/entrychain.py:285 (_stem_kernel; "
                     "fused_stem :322, pallas_call :354)",
        ),
    }
    for name, k in kernels.items():
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            ref = k["plain"](x).float()
            got = k["kernel"](x)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            max_err, max_ref = err.max().item(), ref.abs().max().item()
            mean_err, mean_ref = err.mean().item(), ref.abs().mean().item()
            if not torch.isfinite(got.float()).all():
                fail(f"{name} {dt}: non-finite output")
            if dt == torch.float32:
                ok, rule = max_err <= 1e-4 * max_ref, "max|err| <= 1e-4 max|ref|"
            else:
                ok = max_err <= 3e-2 * max_ref and mean_err <= 2e-3 * mean_ref
                rule = "max|err| <= 3e-2 max|ref|, mean|err| <= 2e-3 mean|ref|"
            dname = dtype_name(dt)
            # time the kernel alone (weights packed once, no counter)
            entry, groups = k["launch"]
            packed = entrychain.pack_weights(x, *groups)
            out = torch.empty_like(got)
            kernel_ms = median_ms(torch, lambda: entrychain._launch(
                entry, k["block1"], x, packed, out))
            plain_ms = median_ms(torch, lambda: k["plain"](x))
            bound_ms, bound_by = entry_bound(n, h, w, k["block1"], dname, x.element_size())
            print(f"{card} {name} {dname} {tuple(x.shape)}: max|err| {max_err:.6g} "
                  f"(max|ref| {max_ref:.6g}), mean|err| {mean_err:.6g} (mean|ref| "
                  f"{mean_ref:.6g}) [{rule}: {'ok' if ok else 'FAIL'}]; kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            k[dname] = dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    return kernels


# ------------------------------------------------------------ separable conv
# The flagship's layers, (N, H, W, C) of the layer's input at a 1024x2048
# image. ``main``: the case whose bf16 numbers stand for the entry point in
# the ``kernels`` line (the shape its main path launches most).
SEPCONV_CASES = [
    dict(fn="fused_sepconv_infer_v3", what="middle flow sep1/sep2, output stride 8",
         shape=(1, 128, 256, 728), co=728, d=2, relu=True, int8=True, main=True),
    dict(fn="fused_sepconv_infer_v3", what="block2 sep1 (128-channel input)",
         shape=(1, 256, 512, 128), co=256, d=1, relu=True, int8=True),
    dict(fn="fused_sepconv_infer_v3_skip", what="middle flow block end, sum skip",
         shape=(1, 128, 256, 728), co=728, d=2, relu=True, int8=True, skip="sum", main=True),
    dict(fn="fused_sepconv_infer_v3_skip", what="block2 end, stride 2, conv skip",
         shape=(1, 256, 512, 256), co=256, d=1, stride=2, relu=True, int8=True,
         skip="conv", cin=128),
    dict(fn="fused_sepconv_infer_v3_skip", what="block3 end at output stride 8, conv skip",
         shape=(1, 128, 256, 728), co=728, d=1, relu=True, int8=True, skip="conv", cin=256),
    dict(fn="fused_sepconv_infer_v3_skip", what="block2 end, stride 2, conv skip, no int8",
         shape=(1, 256, 512, 256), co=256, d=1, stride=2, relu=True, int8=False,
         skip="conv", cin=128),
    dict(fn="fused_sepconv_infer_v2", what="middle flow layer, output stride 16",
         shape=(1, 64, 128, 728), co=728, d=1, relu=True, int8=False, main=True),
    dict(fn="fused_sepconv_infer_v2", what="block2 sep1 (128-channel input)",
         shape=(1, 256, 512, 128), co=256, d=1, relu=True, int8=False),
    dict(fn="fused_sepconv_infer", what="decoder1 (256 -> 256, no ReLU)",
         shape=(1, 256, 512, 256), co=256, d=1, relu=False, int8=False, main=True),
    # 1536 channels: beyond what the kernel keeps resident in shared memory, so
    # these take its other variant (the depthwise recomputed per Co tile)
    dict(fn="fused_sepconv_infer_v2", what="exit flow sep3 (1536 -> 2048), output stride 16",
         shape=(1, 64, 128, 1536), co=2048, d=2, relu=False, int8=False),
    dict(fn="fused_sepconv_infer_v3", what="exit flow sep3 (1536 -> 2048), output stride 16",
         shape=(1, 64, 128, 1536), co=2048, d=2, relu=False, int8=True),
]
SEPCONV_REPLACES = {
    "fused_sepconv_infer_v3": "segmentron_tpu/ops/sepconv.py:282 (_kernel_v3; "
                              "fused_sepconv_infer_v3 :558, pallas_call :591)",
    "fused_sepconv_infer_v3_skip": "segmentron_tpu/ops/sepconv.py:396 (_kernel_v3_skip; "
                                   "fused_sepconv_infer_v3_skip :464, pallas_call :506)",
    "fused_sepconv_infer_v2": "segmentron_tpu/ops/sepconv.py:174 (_kernel_v2; "
                              "fused_sepconv_infer_v2 :212, pallas_call :239)",
    "fused_sepconv_infer": "segmentron_tpu/ops/sepconv.py:86 (_kernel; "
                           "fused_sepconv_infer :632, pallas_call :651)",
}


def sepconv_bound(case, itemsize, dname):
    """(ms, 'bytes' | 'operations') for one call: x, x_in and the weights
    read once, the output written once; the depthwise taps at the f32
    CUDA-core peak, the products at the tensor-core peak of their type
    (f32 I/O: the CUDA-core peak)."""
    n, h, w, c = case["shape"]
    co, s = case["co"], case.get("stride", 1)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    skip, cin = case.get("skip"), case.get("cin", 0)
    pix = n * ho * wo
    wsize = 1 if case["int8"] else itemsize
    nbytes = n * h * w * c * itemsize + pix * co * itemsize + c * co * wsize + (11 * c + 2 * co) * 4
    if skip == "conv":
        nbytes += n * h * w * cin * itemsize + cin * co * itemsize + 2 * co * 4
    elif skip == "sum":
        nbytes += pix * co * itemsize
    t_ops = 2 * pix * c * 9 / PEAK_OPS["float32"]
    t_ops += 2 * pix * c * co / PEAK_OPS["int8" if case["int8"] else dname]
    if skip == "conv":
        t_ops += 2 * pix * cin * co / PEAK_OPS[dname]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sepconv_inputs(torch, sepconv, case, dt, gen, dev):
    """The case's arrays in ``dt``: activations ~N(0,1), LeCun-normal
    products, BN-like affines. Returns (positional arguments of the
    entry point, keyword arguments, the same as a dict by role)."""
    n, h, w, c = case["shape"]
    co, cin, skip = case["co"], case.get("cin", 0), case.get("skip")

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    def pos(k):
        return (torch.rand(k, generator=gen) + 0.5).to(dev)

    x = randn(n, h, w, c).to(dt)
    dw = randn(3, 3, 1, c, scale=0.3)
    a1, b1 = pos(c), randn(c, scale=0.1)
    pw = randn(c, co, scale=1 / math.sqrt(c)).to(dt)
    a2, b2 = pos(co), randn(co, scale=0.1)
    if case["int8"]:
        ms, mb, wq, osc = sepconv.fold_sepconv_int8(a1, b1, pw, a2)
        weights = (dw, ms, mb, wq, osc, b2)
    else:
        weights = (dw, a1, b1, pw, a2, b2)
    roles = dict(x=x, x_in=None, weights=weights, skip_weights=())
    kw = dict(dilation=case["d"], pre_relu=case["relu"])
    if skip is None:
        if case["fn"] == "fused_sepconv_infer_v3":
            kw["int8_dot"] = case["int8"]
        return (x, *weights), kw, roles
    kw.update(stride=case.get("stride", 1), int8_dot=case["int8"], skip=skip)
    if skip == "sum":
        roles["x_in"] = randn(n, h, w, co).to(dt)
    else:
        roles["x_in"] = randn(n, h, w, cin).to(dt)
        roles["skip_weights"] = (randn(1, 1, cin, co, scale=1 / math.sqrt(cin)).to(dt),
                                 pos(co), randn(co, scale=0.1))
    return (x, roles["x_in"], *weights, *roles["skip_weights"]), kw, roles


def check_sepconv_kernels(torch, sepconv, card, dev, gen):
    """Every case in f32 and bf16: the wrapper (which launches the
    kernel) against the plain version, and their times."""
    results = {}
    for case in SEPCONV_CASES:
        wrapper = getattr(sepconv, case["fn"])
        plain = getattr(sepconv, case["fn"] + "_plain")
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            args, kw, roles = sepconv_inputs(torch, sepconv, case, dt, gen, dev)
            ref = plain(*args, **kw).float()
            before = wrapper.launches
            got = wrapper(*args, **kw)
            torch.cuda.synchronize()
            if wrapper.launches != before + 1:
                fail(f"{case['fn']}: the wrapper did not count its launch")
            if got.shape != ref.shape or not torch.isfinite(got.float()).all():
                fail(f"{case['fn']} {dname} {case['what']}: shape {tuple(got.shape)} vs "
                     f"{tuple(ref.shape)} or non-finite output")
            err = (got.float() - ref).abs()
            max_err, max_ref = err.max().item(), ref.abs().max().item()
            mean_err, mean_ref = err.mean().item(), ref.abs().mean().item()
            # Bars. f32 products: sums in another order. bf16: also the
            # rounding of the depthwise result and of the output to bf16
            # (one bf16 ulp = 2^-8 relative), where a last-bit difference
            # of an f32 sum now and then flips a rounding. int8_dot: a
            # depthwise result within an f32 ulp of a half-integer rounds
            # to the other int8 value, which moves an output by at most
            # 127 * out_scale (one int8 step of the output scale); two
            # such steps in one output are allowed.
            out_scale = roles["weights"][4]
            step = 127.0 * out_scale.abs().max().item() if case["int8"] else 0.0
            if dt == torch.float32:
                ok = max_err <= 1e-4 * max_ref + 2 * step
                rule = "max|err| <= 1e-4 max|ref| + 2 int8 steps"
            else:
                ok = max_err <= 3e-2 * max_ref + 2 * step and mean_err <= 2e-3 * mean_ref
                rule = "max|err| <= 3e-2 max|ref| + 2 int8 steps, mean|err| <= 2e-3 mean|ref|"
            x = roles["x"]
            # time the kernel alone (weights packed once, no counter)
            packed = sepconv.pack_sepconv(x, *roles["weights"], case["int8"],
                                          *roles["skip_weights"])
            launch_kw = dict(dilation=case["d"], pre_relu=case["relu"],
                             stride=case.get("stride", 1), skip=case.get("skip"),
                             x_in=roles["x_in"])
            kernel_ms = median_ms(torch, lambda: sepconv._launch(x, packed, **launch_kw))
            plain_ms = median_ms(torch, lambda: plain(*args, **kw), n=10, warmup=1)
            bound_ms, bound_by = sepconv_bound(case, x.element_size(), dname)
            print(f"{card} {case['fn']} {dname} {case['what']} {tuple(x.shape)} -> "
                  f"{tuple(got.shape)} d={case['d']} int8_dot={case['int8']}: max|err| "
                  f"{max_err:.6g} (max|ref| {max_ref:.6g}, int8 step {step:.6g}), mean|err| "
                  f"{mean_err:.6g} (mean|ref| {mean_ref:.6g}) [{rule}: "
                  f"{'ok' if ok else 'FAIL'}]; kernel {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                fail(f"{case['fn']} {dname} ({case['what']}) disagrees with its plain version")
            if case.get("main"):
                results.setdefault(case["fn"], {})[dname] = dict(
                    max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, shape=list(x.shape), what=case["what"])
            del args, roles, ref, got, err, packed, x
    return results


# -------------------------------------------------------------------- model
def set_routes(model, routes):
    for m in model.modules():
        if hasattr(m, "routes"):
            m.routes = routes


def gated_launches(torch, model, image, predict):
    """Launches the port's gates admit for one forward of ``image``:
    hooks record the input shape of every Xception block and separable
    conv during one forward, then each module's gate is asked about that
    shape."""
    from segmentron_tpu_torch.models.backbones.xception import XceptionBlock
    from segmentron_tpu_torch.modules import SeparableConv2d

    shapes, hooks = {}, []
    for m in model.modules():
        if isinstance(m, (XceptionBlock, SeparableConv2d)):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: shapes.__setitem__(mod, tuple(inp[0].shape))))
    with torch.inference_mode():
        predict(image)
    for h in hooks:
        h.remove()

    def meta(m):
        return torch.empty(shapes[m], device="meta")

    want = dict(fused_sepconv_infer=0, fused_sepconv_infer_v2=0, fused_sepconv_infer_v3=0,
                fused_sepconv_infer_v3_skip=0,
                fused_stem_block1=int(model.backbone._fused_stem_mode(
                    torch.empty((1, 3) + tuple(image.shape[1:3]), device="meta")) == "block1"),
                fused_stem=0)
    in_chain = set()
    for m in shapes:
        if isinstance(m, XceptionBlock) and m._fused_chain(meta(m)):
            want["fused_sepconv_infer_v3_skip"] += 1
            for i in range(m.n_sep):
                sep = getattr(m, f"sep{i + 1}")
                in_chain.add(sep)
                if i < m.n_sep - 1 and sep._v3_tile(meta(sep), True) is not None:
                    want["fused_sepconv_infer_v3"] += 1
    for m in shapes:
        if (isinstance(m, SeparableConv2d) and m not in in_chain and not m._int8_pw_mode()
                and m._fusable(meta(m))):
            want["fused_sepconv_infer_v2"] += 1
    return want


def probe(torch, card):
    """Cycle shares of the fused separable conv's phases (see the
    module's docstring)."""
    import ctypes

    from segmentron_tpu_torch.ops import kernels, sepconv

    kernels.DEFINES["sepconv"] = ("-DSEPCONV_PROFILE",)
    lib = sepconv._lib()
    lib.sepconv_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen, dev = torch.Generator().manual_seed(0), torch.device("cuda")
    for case in (c for c in SEPCONV_CASES if c.get("main")):
        args, kw, _ = sepconv_inputs(torch, sepconv, case, torch.bfloat16, gen, dev)
        fn = getattr(sepconv, case["fn"])
        fn(*args, **kw)  # warm up
        torch.cuda.synchronize()
        lib.sepconv_probe(None, 1)
        fn(*args, **kw)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 4)()
        if lib.sepconv_probe(counts, 0) != 0:
            fail("sepconv_probe failed")
        taps, phase2, epilogue, blocks = (float(c) for c in counts)
        total = taps + phase2
        n_chunks = -(-case["shape"][3] // 32)
        print(f"{card} {case['fn']} bfloat16 {case['what']} int8_dot={case['int8']}: "
              f"{int(blocks)} blocks, {total / blocks:.0f} cycles a block: taps "
              f"{taps / total:.3f} ({taps / blocks / n_chunks:.0f} cycles a 32-channel chunk), "
              f"products {(phase2 - epilogue) / total:.3f}, epilogue {epilogue / total:.3f}")
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import Evaluator, make_predict_fn
    from segmentron_tpu_torch.models import get_segmentation_model
    from segmentron_tpu_torch.modules import SepconvRoutes
    from segmentron_tpu_torch.ops import entrychain, sepconv
    from segmentron_tpu_torch.ops.kernels import BUILD_DIR, SOURCES, build

    if "segmentron_tpu" in sys.modules or "jax" in sys.modules:
        fail("JAX or the JAX package was imported")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {smi}")
    if "--probe" in sys.argv[1:]:
        return probe(torch, card)

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    per_source = build(SOURCES)
    print(f"{card} build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")
    for log in sorted(BUILD_DIR.glob("*.log")):
        lines = [ln for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        with open(os.path.join(OUT_DIR, log.name), "w") as f:
            f.write(log.read_text())
        print(f"ptxas {log.name}: " + " | ".join(ln.strip() for ln in lines[:16]))

    # ----------------------------------------------------------- 3. kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    wrappers = {
        "fused_stem_block1": entrychain.fused_stem_block1,
        "fused_stem": entrychain.fused_stem,
        **{name: getattr(sepconv, name) for name in SEPCONV_REPLACES},
    }

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    sep_results = check_sepconv_kernels(torch, sepconv, card, dev, gen)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"sepconv": sep_results}))
        print(f"kernels only: {time.perf_counter() - t_start:.1f} s")
        return 0
    entry_kernels = check_entry_kernels(torch, entrychain, card, dev, gen)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 4. model
    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list(["DATASET.NAME", "synthetic"])
    gen = torch.Generator().manual_seed(int(cfg.SEED))
    model = get_segmentation_model(dev, generator=gen)
    with torch.no_grad():  # non-trivial BN statistics, so the fold is exercised
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) * 0.5 + 0.75)
    bb = model.backbone
    routes_plain = SepconvRoutes.from_cfg(cfg)
    cfg.update_from_list(PATH_A)
    routes_a = SepconvRoutes.from_cfg(cfg)
    cfg.update_from_list(["TPU.USE_PALLAS_SEPCONV", "False"] + PATH_B)
    routes_b = SepconvRoutes.from_cfg(cfg)
    model8 = get_segmentation_model(dev, generator=gen)  # path B, as a user builds it
    model8.load_state_dict(model.state_dict())
    routes_b_unfused = SepconvRoutes(int8="pw", int8_k=routes_b.int8_k)
    cfg.update_from_list(["MODEL.OUTPUT_STRIDE", "16", "TPU.INT8_ACTIVATIONS", "False",
                          "TPU.FUSED_SEPCONV_V3", "False", "TPU.FUSED_ENTRY_V3", ""])
    print(f"model: DeepLabV3_Plus/xception65, {bb.middle_blocks} middle blocks, nclass "
          f"{model.nclass}, {sum(p.numel() for p in model.parameters())} parameters; output "
          f"stride 16 (default, path A {routes_a}) and 8 (path B {routes_b})")

    def agreement(a, b):
        return (a == b).float().mean().item()

    small = torch.randn(1, 64, 128, 3, generator=gen).to(dev)
    with torch.inference_mode():
        fused = model(small)[0]
        bb.fused_stem = False
        plain = model(small)[0]
        bb.fused_stem = cfg.TPU.FUSED_STEM
        set_routes(model, routes_a)
        zero_counts()
        small_a = model(small)[0]
        small_a_launches = read_counts()["fused_sepconv_infer_v2"]
        set_routes(model, routes_plain)
        # path B at the small input: the byte gate lowered so that the
        # middle flow's chains run here too
        set_routes(model8, routes_plain)
        b_f32 = model8(small)[0]
        set_routes(model8, routes_b_unfused)
        b_unfused = model8(small)[0]
        set_routes(model8, dataclasses.replace(routes_b, min_bytes=1))
        zero_counts()
        b_fused = model8(small)[0]
        small_b_launches = read_counts()
    scale = max(1.0, plain.abs().max().item())
    small_err = (fused - plain).abs().max().item()
    small_a_err = (small_a - plain).abs().max().item()
    print(f"{card} f32 (1, 64, 128, 3): fused entry vs plain modules max|err| "
          f"{small_err:.6g}, path A ({small_a_launches} fused layers) vs plain modules "
          f"max|err| {small_a_err:.6g} (scale {scale:.6g}) [<= 1e-3 scale]")
    if not (torch.isfinite(fused).all() and small_err <= 1e-3 * scale):
        fail("fused entry disagrees with the plain modules in f32")
    if not (torch.isfinite(small_a).all() and small_a_err <= 1e-3 * scale
            and small_a_launches > 0):
        fail("path A disagrees with the plain modules in f32, or launched no kernel")
    quant_err = (b_unfused - b_f32).abs().max().item()
    chain_err = (b_fused - b_unfused).abs().max().item()
    print(f"{card} f32 (1, 64, 128, 3) output stride 8: int8 'pw' unfused vs f32 model "
          f"max|err| {quant_err:.6g}; fused chains vs unfused max|err| {chain_err:.6g} "
          f"[<= the unfused route's own distance from the f32 model]; launches "
          f"{small_b_launches}")
    if not (torch.isfinite(b_fused).all() and chain_err <= quant_err):
        fail("path B: the fused chains are further from the unfused int8 route than that "
             "route is from the f32 model")
    if not (small_b_launches["fused_sepconv_infer_v3"] > 0
            and small_b_launches["fused_sepconv_infer_v3_skip"] > 0):
        fail(f"path B launched no kernel chain at the small input: {small_b_launches}")

    dataset = SyntheticSegmentation(split="val", mode="testval", length=4,
                                    image_size=SHAPE[1:3])
    image = torch.from_numpy(dataset[0][0][None]).to(dev)
    routes = ("block1", "stem", False)

    def route_preds(predict):
        """{entry route: argmax of the logits of ``image``}."""
        preds = {}
        with torch.inference_mode():
            for route in routes:
                bb.fused_stem = route
                preds[route] = predict(image).argmax(-1)
        bb.fused_stem = cfg.TPU.FUSED_STEM
        return preds

    def sep_preds(mdl, predict, named_routes):
        """{name: argmax of the logits of ``image``} per sepconv route."""
        preds = {}
        with torch.inference_mode():
            for name, r in named_routes.items():
                set_routes(mdl, r)
                preds[name] = predict(image).argmax(-1)
        return preds

    predict32 = make_predict_fn(model, "float32", dev)
    ref = route_preds(predict32)
    ref["A"] = sep_preds(model, predict32, {"A": routes_a})["A"]
    set_routes(model, routes_plain)
    agree32 = {str(r): agreement(ref[r], ref[False]) for r in ("block1", "stem", "A")}
    print(f"{card} f32 {SHAPE}: argmax agreement of the fused routes with the plain "
          f"modules {agree32} [>= 0.995]")
    if min(agree32.values()) < 0.995:
        fail("a fused route's argmax agreement with the plain modules is below 0.995 in f32")
    routes8 = {"f32": routes_plain, "unfused": routes_b_unfused, "B": routes_b}
    ref8 = sep_preds(model8, make_predict_fn(model8, "float32", dev), routes8)
    agree8_32 = {k: agreement(ref8[k], ref8["f32"]) for k in ("unfused", "B")}
    print(f"{card} f32 {SHAPE} output stride 8, int8 'pw': argmax agreement with the f32 "
          f"model {agree8_32}; fused chains vs unfused {agreement(ref8['B'], ref8['unfused']):.6f}")
    torch.backends.cudnn.allow_tf32 = True  # the model's own default from here on

    # -------------------------------------------------------- 5. main paths
    def run_eval(mdl, n_images):
        """The ``Evaluator`` over the first ``n_images`` images, with the
        launch counters read around it."""
        data = SyntheticSegmentation(split="val", mode="testval", length=n_images,
                                     image_size=SHAPE[1:3])
        evaluator = Evaluator(mdl, data)  # casts the weights to bf16
        zero_counts()
        t0 = time.perf_counter()
        pix_acc, miou, _ = evaluator.eval()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        cm = evaluator.metric.confusion_matrix
        labelled = sum(int(((m >= 0) & (m < mdl.nclass)).sum())
                       for m in (data[i][1] for i in range(len(data))))
        if cm.sum() != labelled:
            fail("confusion-matrix total differs from the labelled pixel count")
        return evaluator, dict(images=n_images, seconds=seconds, pix_acc=pix_acc, miou=miou,
                               launches=counts)

    def check_counts(name, mdl, predict, got, n_images):
        want = {k: v * n_images for k, v in gated_launches(torch, mdl, image, predict).items()}
        print(f"{card} {name}: launches {got} ; the gates admit {want}")
        if got != want:
            fail(f"{name}: launches differ from what the gates admit")
        return want

    evaluator, main_default = run_eval(model, len(dataset))
    predict = evaluator.predict_fn
    print(f"{card} eval, default path: {main_default['images']} images {SHAPE[1]}x{SHAPE[2]} "
          f"{cfg.TPU.COMPUTE_DTYPE} in {main_default['seconds']:.3f} s: pixAcc "
          f"{main_default['pix_acc']:.6f}, mIoU {main_default['miou']:.6f}")
    check_counts("default path", model, predict, main_default["launches"], len(dataset))
    if main_default["launches"]["fused_stem_block1"] != len(dataset):
        fail("fused_stem_block1 was not launched once per image")

    set_routes(model, routes_a)
    evaluator_a, main_a = run_eval(model, 2)
    print(f"{card} eval, path A: {main_a['images']} images in {main_a['seconds']:.3f} s: "
          f"pixAcc {main_a['pix_acc']:.6f}, mIoU {main_a['miou']:.6f}")
    want_a = check_counts("path A", model, predict, main_a["launches"], 2)
    if want_a["fused_sepconv_infer_v2"] == 0:
        fail("path A: the gates admit no layer")
    set_routes(model, routes_plain)

    set_routes(model8, routes_b)
    evaluator_b, main_b = run_eval(model8, 2)
    predict8 = evaluator_b.predict_fn
    print(f"{card} eval, path B: {main_b['images']} images in {main_b['seconds']:.3f} s: "
          f"pixAcc {main_b['pix_acc']:.6f}, mIoU {main_b['miou']:.6f}")
    want_b = check_counts("path B", model8, predict8, main_b["launches"], 2)
    if not (want_b["fused_sepconv_infer_v3"] and want_b["fused_sepconv_infer_v3_skip"]
            and want_b["fused_stem_block1"]):
        fail("path B: the gates admit no kernel chain")

    with torch.inference_mode():
        logits = predict(image)
        logits8 = predict8(image)
        for lg in (logits, logits8):
            if lg.shape != (1, SHAPE[1], SHAPE[2], model.nclass):
                fail(f"logits shape {tuple(lg.shape)}")
            if not torch.isfinite(lg).all():
                fail("non-finite logits")
        # the fused and the plain-modules entry in turns, 3 rounds of 10
        fwd = {"block1": [], False: []}
        for rnd in range(3):
            for route in (("block1", False) if rnd % 2 == 0 else (False, "block1")):
                bb.fused_stem = route
                fwd[route].append(median_ms(torch, lambda: predict(image), n=10, warmup=2))
        bb.fused_stem = cfg.TPU.FUSED_STEM
        # paths A and B and their unfused twins in turns, 2 rounds of 8
        turns = {"A": (model, predict, routes_a), "A unfused": (model, predict, routes_plain),
                 "B": (model8, predict8, routes_b),
                 "B unfused": (model8, predict8, routes_b_unfused)}
        fwd_paths = {name: [] for name in turns}
        for rnd in range(2):
            for name in (list(turns) if rnd == 0 else reversed(list(turns))):
                mdl, fn, r = turns[name]
                set_routes(mdl, r)
                fwd_paths[name].append(median_ms(torch, lambda: fn(image), n=8, warmup=2))
        set_routes(model, routes_plain)
        set_routes(model8, routes_b)
    fwd_ms, plain_fwd_ms = statistics.median(fwd["block1"]), statistics.median(fwd[False])
    path_ms = {name: statistics.median(v) for name, v in fwd_paths.items()}
    print(f"{card} forward (1, {SHAPE[1]}, {SHAPE[2]}, 3) uint8 -> f32 logits, bf16, ms "
          f"(img/s), medians of rounds in turns: " + "; ".join(
              f"{name} {ms:.3f} ({1e3 / ms:.2f}) {[round(v, 3) for v in fwd_paths[name]]}"
              for name, ms in path_ms.items()))

    zero_counts()
    half = route_preds(predict)  # one forward per route: the stem route's own path
    route_launches = read_counts()
    half["A"] = sep_preds(model, predict, {"A": routes_a})["A"]
    set_routes(model, routes_plain)
    half8 = sep_preds(model8, predict8, {"unfused": routes_b_unfused, "B": routes_b})
    # The random model's argmax is itself sensitive to bf16 rounding, so
    # each bf16 route is held to the f32 reference no worse than the
    # plain modules' own bf16 route is.
    agree16 = {str(r): agreement(half[r], ref[False]) for r in (*routes, "A")}
    print(f"{card} forward, {cfg.TPU.COMPUTE_DTYPE}: fused entry {fwd_ms:.3f} ms "
          f"({1e3 / fwd_ms:.2f} img/s), plain modules entry {plain_fwd_ms:.3f} ms "
          f"({1e3 / plain_fwd_ms:.2f} img/s) [medians of rounds {fwd['block1']} and "
          f"{fwd[False]}]; argmax agreement with the f32 plain "
          f"reference per bf16 route {agree16}; bf16 fused vs bf16 plain: block1 "
          f"{agreement(half['block1'], half[False]):.6f}, stem "
          f"{agreement(half['stem'], half[False]):.6f}, A "
          f"{agreement(half['A'], half[False]):.6f}; launches {route_launches}")
    if min(agree16["block1"], agree16["stem"], agree16["A"]) < agree16["False"] - 0.005:
        fail("a fused route's bf16 argmax is further from the f32 reference than "
             "the plain modules' by more than 0.005")
    if (route_launches["fused_stem_block1"], route_launches["fused_stem"]) != (1, 1):
        fail(f"route launches {route_launches}")
    # Path B: int8 noise on a random 16-block net flips far more pixels
    # than bf16 does, and the fused chains round at other points than the
    # unfused route (1/s_mid folded before the rounding; the residual
    # added before the cast), so the two are equally far from the f32
    # model only up to that noise: held to the unfused route's agreement
    # less 0.02, in f32 and in bf16.
    agree8_16 = {k: agreement(half8[k], ref8["f32"]) for k in ("unfused", "B")}
    print(f"{card} path B, output stride 8: argmax agreement with the f32 model, f32 I/O "
          f"{agree8_32}, bf16 I/O {agree8_16}; bf16 fused chains vs bf16 unfused "
          f"{agreement(half8['B'], half8['unfused']):.6f} [B >= unfused - 0.02]")
    for agree in (agree8_32, agree8_16):
        if agree["B"] < agree["unfused"] - 0.02:
            fail("path B's argmax is further from the f32 model than the unfused int8 "
                 "route's by more than 0.02")

    # fused_sepconv_infer has no caller in either package's models: its
    # count is of one direct call at the decoder's shape
    direct = next(c for c in SEPCONV_CASES if c["fn"] == "fused_sepconv_infer")
    args, kw, _ = sepconv_inputs(torch, sepconv, direct, torch.bfloat16, gen, dev)
    zero_counts()
    sepconv.fused_sepconv_infer(*args, **kw)
    torch.cuda.synchronize()
    direct_launches = read_counts()["fused_sepconv_infer"]
    del args

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_forward(fn, label, path):
        with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(image)
            torch.cuda.synchronize()
            window_us = 1e6 * (time.perf_counter() - t0)
        averages = prof.key_averages()
        table = averages.table(sort_by="self_device_time_total", row_limit=40)
        with open(os.path.join(OUT_DIR, path), "w") as f:
            f.write(f"{card} one forward, {label}, {cfg.TPU.COMPUTE_DTYPE}, "
                    f"1x{SHAPE[1]}x{SHAPE[2]}\n")
            f.write(table)
        device_kernels = sorted((e for e in averages if e.device_type == DeviceType.CUDA),
                                key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in device_kernels)
        print(f"{card} profile of one forward, {label}: kernels {device_us / 1e3:.3f} ms of "
              f"a {window_us / 1e3:.3f} ms window (device idle share "
              f"{1 - device_us / window_us:.4f}), {sum(e.count for e in device_kernels)} "
              f"launches; top kernels by device time:")
        for e in device_kernels[:12]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")

    profile_forward(predict, "default path", "chip_smoke_profile.txt")
    profile_forward(predict8, "path B", "chip_smoke_profile_path_b.txt")
    set_routes(model8, routes_b_unfused)
    profile_forward(predict8, "path B unfused", "chip_smoke_profile_path_b_unfused.txt")

    # ------------------------------------------------------------ results
    # per forward of the path that runs the kernel: fused_stem lies on the
    # FUSED_STEM="stem" route, v2 on path A, v3 and v3_skip on path B
    launches = {
        "fused_stem_block1": main_default["launches"]["fused_stem_block1"],
        "fused_stem": route_launches["fused_stem"],
        "fused_sepconv_infer_v3": main_b["launches"]["fused_sepconv_infer_v3"],
        "fused_sepconv_infer_v3_skip": main_b["launches"]["fused_sepconv_infer_v3_skip"],
        "fused_sepconv_infer_v2": main_a["launches"]["fused_sepconv_infer_v2"],
        "fused_sepconv_infer": direct_launches,
    }
    for name, count in launches.items():
        if count < 1:
            fail(f"{name} was launched no time on its path")
    measured = {name: (ENTRY_SOURCE, k["replaces"], k["bfloat16"])
                for name, k in entry_kernels.items()}
    measured.update({name: (SEPCONV_SOURCE, SEPCONV_REPLACES[name], sep_results[name]["bfloat16"])
                     for name in SEPCONV_REPLACES})
    line = {"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], max_abs_err=m["max_abs_err"], ms=m["ms"],
             plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
             library_ms=None)
        for name, (source, replaces, m) in measured.items()
    ]}
    not_ported = {"kernels_not_ported": [
        "segmentron_tpu/ops/attention.py:44 (_flash_kernel)",
        "segmentron_tpu/ops/attention.py:161 (_flash_bwd_dq_kernel), :185 (_flash_bwd_dkv_kernel)",
        "tools/ceiling_probe.py:298 (kern)",
    ]}
    summary = {"card": smi, "forward_ms": fwd_ms, "img_per_s": 1e3 / fwd_ms,
               "plain_entry_forward_ms": plain_fwd_ms, "path_forward_ms": path_ms,
               "argmax_agreement_f32": agree32, "argmax_agreement_bf16_vs_f32": agree16,
               "path_b_argmax_agreement_with_f32": {"f32": agree8_32, "bf16": agree8_16},
               "eval": {"default": main_default, "A": main_a, "B": main_b},
               "f32": {**{name: k["float32"] for name, k in entry_kernels.items()},
                       **{name: r["float32"] for name, r in sep_results.items()}},
               "seconds": time.perf_counter() - t_start}
    print(json.dumps(summary))
    print(json.dumps(not_ported))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
