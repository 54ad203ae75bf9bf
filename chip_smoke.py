#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``segmentron_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--kernels-only | --train | --eval | --probe | --probe-dot
                           | --entry [--baseline=<path>] | --entry-probe[=stem|block1]
                           | --sepconv [--baseline=<path>] | --sepconv-probe
                           | --flash-fwd [--baseline=<path>] | --flash-fwd-probe
                           | --flash-bwd [--baseline=<path>]
                           | --flash-bwd-probe[=f32|bf16]]

Phases, each fatal on failure (exit code != 0, no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA source under ``segmentron_tpu_torch/csrc`` with
   ``nvcc``, all started together;
3. kernels: each hand-written kernel against its plain PyTorch version
   at the shapes the full-width model gives it, in f32 (TF32 off) and
   bf16, with the stated tolerances; times by CUDA events (median of 20
   after warm-up) beside the bound the card sets for the same work. The
   entry chain at (1, 1024, 2048, 3) and, in bf16, at small images (one
   tile, ragged tile rows or columns, two images; ``entry_small_cases``),
   before it ``csrc/entrychain.cu``'s ptxas report, the SASS of
   ``stem_block1_wgmma_kernel`` (HGMMA and UTMALDG required) and of
   ``stem_wgmma_kernel`` (HGMMA, UTMALDG and UTMASTG required; no spill,
   no ptxas wgmma-serialisation warning) and their plans (``entry_plan``,
   ``stem_plan``) against ``ops/entrychain.py``'s mirrors
   (``check_entry_build``, ``check_entry_plans``); the fused separable conv
   (``ops/sepconv.py``, four entry points) at the flagship's layers: a
   728-channel middle-flow layer with dilation 2 and its sum-skip block
   end (output stride 8, ``int8_dot``), the stride-2 conv-skip end of
   block2 at 256x512, block3's conv-skip end, a 128-channel layer, the
   output-stride-16 middle layer, a decoder layer and a 1536-channel
   exit-flow layer (bf16 / f32 products), each time also with the launch
   hidden behind a spin of the card (``ms_launch_hidden``) and the host's
   microseconds a call (``host_us``); before it, ``csrc/sepconv.cu``'s
   ptxas report and SASS (``check_sepconv_build``) and its plans against
   ``ops/sepconv.py::sepconv_plan`` (``check_sepconv_plans``), and after
   it every bf16 stride-1 case (the v3 and v2 main cases, the sum-skip and
   block3's conv-skip block ends) must have taken ``sepconv_wgmma_kernel``;
   the flash-attention forward
   (``ops/attention.py``) at DANet's and OCNet's shapes (P = 32768, and
   the pyramid's N=4/P=8192 and N=9/P=3698), their train shapes (N=16,
   P=5184) and two small ragged cases, out and lse against the plain
   version over the kernel's key tiles (``fwd_plan``), beside
   ``scaled_dot_product_attention``'s time; in f32 the route is the split
   pass (``flash_attention_split``, its pieces bitwise against
   ``split_pieces_plain``) and the kernel on q's and k's bf16 pieces and
   f32 v, timed whole and each alone, held also at 2.5e-5 of max|ref| (lse
   1e-5 of max|lse|), beside two bounds: its own work (six bf16 products
   for q.k^T at the bf16 peak, with and without the Dv split, beside p.v
   on the FMA units) and all of it on CUDA-core FMA; before it, both
   forward kernels' SASS must hold ``HGMMA`` and ``UTMALDG``, the f32
   kernel's no function call, no ``HGMMA`` waited on alone and no spill,
   and their plans (``flash_attention_plan``) must equal
   ``ops/attention.py::fwd_plan`` at every (Dk, Dv) in both dtypes; the
   flash-attention backward (dq and dk/dv kernels) at DANet's and OCNet's
   train shapes (N=16, P=5184), the pyramid's N=9/P=3698 and a ragged
   case, against ``flash_attention_bwd_plain``, beside the backward of
   ``scaled_dot_product_attention``; in f32 beside two bounds, split TF32
   (three TF32 products for each, the kernels' arithmetic) and CUDA-core
   FMA; before it, the bf16 kernels' SASS must hold ``HGMMA`` (``wgmma``)
   and ``UTMALDG`` (TMA loads), and their tiles as the source picks them
   (``flash_attention_bwd_plan``) must equal ``ops/attention.py::bwd_plan``;
3b. the ceiling probe (``segmentron_tpu_torch/tools/ceiling_probe.py``):
   its kernel ``probe_dot`` against ``probe_dot_plain`` at (8192, 728),
   (8192, 768), the ragged (300, 40, 72) and (129, 33, 17) and the deep
   (520, 1000, 200), int8 bitwise and bf16 within one bf16 ulp (plus the
   f32 rounding of K products), beside the bound, the plain version and
   the library (``torch._int_mm``, ``torch.matmul``); each case's route
   (wgmma or mma.sync, TMA or cp.async) as the source picks it, held to
   its mirror ``ops/probe_dot.py::plan``, and ptxas's registers and spills
   of each kernel specialisation;
   then every probe mode once through the tool's functions at full shapes,
   ``CP_TARGET`` 4e11 and ``CP_ITERS`` 3, the counters zeroed around each:
   ``pallas_dot`` launches the kernel once warm and once a captured
   iteration, ``flagship`` the fused entry kernel. ``--kernels-only``
   stops here;
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
   forward times of the default entry, the "stem" route and the plain
   modules' entry in turns, and of A, B and their unfused twins in
   turns; each bf16 route's argmax against its f32 reference, no
   further from it than its unfused twin; profiler breakdowns of one
   forward of the default path and of path B (written to ``OUT_DIR``);
6. DANet and OCNet over ResNet-101 at output stride 8, from their
   serving YAMLs on the bf16 path (``TPU.INT8_RESNET False``), full
   width, random weights with PAM's and CAM's ``gamma`` set to
   ``GAMMA``: in f32 the flash-kernel route against the dense route
   (argmax >= 0.995; DANet, OCNet base and pyramid; one split pass and
   one kernel launch a flash attention), the f32 forward timed and
   profiled for the flash forward's share of it; DANet and OCNet
   base through the ``Evaluator`` in bf16 with the counters read around
   it (one launch a forward), the bf16 kernel route's argmax held to the
   f32 reference no worse than the dense route's (-0.005), both routes
   timed in turns, one profile each; OCNet pyramid's three launches;
7. DANet and OCNet base training from the COCO-Stuff YAMLs (576x576
   crops, batch 16, bf16) through ``get_segmentation_loss``,
   ``get_lr_scheduler``, ``get_optimizer`` and ``make_train_step``: in
   f32 at batch 2 the kernel route against the dense route (loss,
   gradients, parameters after the update; a float64 step sets the
   gradients' bar), bf16 gradients against f32, then the bf16 step at
   batch 16 with the counters read around it (flash forward, dq and
   dk/dv once each), steps of both routes in turns, peak memory, the step
   with ``cudnn.benchmark``, one profile each;
8. flagship training (``flagship_train``): DeepLabv3+ / Xception-65 at
   full width from the flagship YAML on a Cityscapes tree written to a
   temporary directory (32 train, 4 val pairs of 1024x2048, removed at the
   end), 768x768 crops augmented on the card: the bf16 entry kernel at
   (2, 768, 768, 3) against its plain version and timed at (1, 768, 768,
   3); ``DeviceAugment`` on the card against the CPU; the train step alone
   at batches 8 and 16 for ``TPU.REMAT`` none, dots and full (peak memory,
   steps in turns, the modes' bf16 losses and f32 updates against each
   other, no kernel launched, one profile); ``tools.train.main`` as a user
   runs it (2 epochs of 2 steps at batch 16, a snapshot and a validation
   each epoch, the entry kernel once an eval batch and never in training),
   then ``--resume`` for a third epoch; the trained model's validation in
   f32 through the entry kernel against the plain entry modules;
9. evaluation and int8 serving (``eval_phase``, on phase 8's tree and
   snapshots before they are removed): (a) every distinct int8 conv of
   ResNet-101 at output stride 8 (``qconv``, recorded from a DANet
   forward): the CUDA route's int32 accumulators (``torch._int_mm``)
   bitwise equal to the plain version's, the f32 output within one ulp,
   the product timed beside the bf16 ``F.conv2d`` it replaces; (b) DANet
   and OCNet from the serving YAMLs with ``TPU.INT8_RESNET`` on
   (``SERVE_OPTS``) at 1024x2048, bf16: the int8-interior forward against
   the bf16 forward of the same weights (argmax agreement, max|d logit|,
   the flash kernel launched once in each), both timed in turns, peak
   memory; (c) ``segmentron_tpu_torch.tools.eval`` on the snapshots
   (latest and ``--best``), with multi-scale and flip TTA and with a 769
   sliding window, each confusion matrix held to an in-process
   ``Evaluator`` on the plain routes, and the DANet serving YAML once.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.

``--train`` builds ``csrc/entrychain.cu`` alone, checks its plans and
runs phase 8 only (the rehearsal after an edit of the training path).
``--eval`` builds ``csrc/entrychain.cu`` and ``csrc/attention.cu``, checks
their plans, writes a Cityscapes tree of 16 train and 4 val pairs, trains
one step through ``tools.train`` (for a latest and a best snapshot) and
runs phase 9 only (the rehearsal after an edit of the evaluation or int8
serving path).
``--probe`` does none of this: it builds ``csrc/sepconv.cu`` with its
clock64 probe and prints, for each main sepconv case in bf16, the share
of the cycles that the taps, the products (for the wgmma kernel: the
waits on them and on the weights) and the epilogue take, for the kernel
the case takes (each main case takes the wgmma kernel; the resident
kernel's shares are printed for a case that takes it).
``--sepconv`` neither: the rehearsal after an edit of
``csrc/sepconv.cu``. It builds that source alone, prints ptxas's
registers and spills of each kernel and the wgmma kernel's SASS counts,
fails on a spill of the wgmma kernel, on a ptxas wgmma-serialisation
warning (C7510-C7520) and where a specialisation lacks HGMMA/IGMMA or
UTMALDG; holds ``sepconv_plan`` (the source's) to
``ops/sepconv.py::sepconv_plan`` at every ``SEPCONV_CASES`` case in both
dtypes and at the flagship's fused layers (``FLAGSHIP_SEPCONV_LAYERS``),
with every bf16 stride-1 case (block ends included) on the wgmma kernel and
the stride-2 and f32 cases on the older kernels; runs phase 3's sepconv check (every
case, f32 and bf16, the bars unchanged); times the default route's own
layer (``SeparableConv2d`` unfused: cuDNN's depthwise conv, the BN
affines, the 1x1 conv) at the two main shapes; and with
``--baseline=<path>`` times another ``sepconv.cu`` (built beside it; the
C interface is the same) against this one at every case in both dtypes
in turns (old, new, new, old), the old results held to the new at the
case's bar. ``--sepconv-probe`` times the wgmma kernel's probe builds
(``SEPCONV_BUILDS``: a phase left out, wrong results, times only) in
turns at the bf16 stride-1 main cases and block ends.
``--entry`` neither: the rehearsal after an edit of
``csrc/entrychain.cu``. It builds that source alone, runs the build and
plan checks above, checks the bf16 stem + block1 and the bf16 stem at small
images (each pixel's error printed as a grid), runs phase 3's entry checks
(both entries, both dtypes, the bars unchanged), times the library route
of each (cuDNN convs and elementwise affines, channels-last bf16), and
with ``--baseline=<path>`` times another ``entrychain.cu`` (PR 15's C
interface) against this one at (1, 1024, 2048, 3) in turns (old, new,
new, old; launch shown, launch hidden, host µs a call): the stem in bf16
and f32, stem + block1 in bf16, with max|old - new| and each against the
plain version. ``--entry-probe`` times the bf16 kernels' probe builds
(``STEM_BUILDS``, ``ENTRY_BUILDS``: a part left out, wrong results, times
only) in turns; ``=stem`` or ``=block1`` takes one kernel.
``--probe-dot`` neither: it times ``csrc/probe_dot.cu`` and its probe
builds, each with a phase left out, at the probe's two shapes, and prints
the median phase stamps of a traced launch.
``--flash-fwd`` neither: the rehearsal after an edit of
``csrc/attention.cu``. It builds that source alone, prints ptxas's
registers and spills of each kernel, runs the forward's SASS and plan
checks and phase 3's flash-forward check (both dtypes, every case);
``--baseline=<path>`` adds, at each case in f32 and bf16, the forward of
another ``attention.cu`` (built beside it; ``flash_attention_launch`` on
f32 or bf16 q, k, v) timed against this source's (in f32 the route, split
pass and kernel) in turns (old, new, new, old), its results held to this
source's at the dtype's bar. ``--flash-fwd-probe`` times the forward
kernels' probe builds (``FLASH_FWD_BUILDS``: a phase left out, wrong
results, times only) in turns at DANet's and OCNet's serving and train
shapes, in f32 (the kernel alone) and bf16.
``--flash-bwd`` neither: the rehearsal after an edit of
``csrc/attention_bwd.cu``. It builds that source alone, prints ptxas's
registers and spills of each kernel, runs the SASS and tile checks above
and phase 3's flash-backward check (both dtypes, every case; out and lse
from the plain forward, so ``csrc/attention.cu`` is not built);
``--baseline=<path>`` adds, at each case in f32 and bf16, the dq and
dk/dv kernels of another ``attention_bwd.cu`` (built beside it; the C
interface is the same) timed against this source's in turns (old, new,
new, old). Any failure exits non-zero.
``--flash-bwd-probe`` times the kernels' probe builds
(``FLASH_BWD_BUILDS`` in f32, ``FLASH_BWD_BF16_BUILDS`` in bf16: a phase
left out, wrong results, times only) in turns at the train shapes, prints
their SASS opcode counts and the card's ``mma.sync`` m16n8k8 tf32 and
``wgmma`` m64nNk16 bf16 rates (``WGMMA_PEAK_MODES``); ``=f32`` or
``=bf16`` takes one dtype.
"""

import dataclasses
import functools
import gzip
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
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
OUT_DIR = "chiprun_out"
SEPCONV_SOURCE = "segmentron_tpu_torch/csrc/sepconv.cu"
ENTRY_SOURCE = "segmentron_tpu_torch/csrc/entrychain.cu"
ATTENTION_SOURCE = "segmentron_tpu_torch/csrc/attention.cu"
ATTENTION_REPLACES = ("segmentron_tpu/ops/attention.py:44 (_flash_kernel; "
                      "_attention_pallas :101, pallas_call :117)")
# The DANet and OCNet serving configs, on the bf16 path for phase 6 (phase 9
# runs their int8 interiors), and the crop is the whole frame (whole-image eval).
ATTENTION_MODELS = {
    "DANet": "configs/serve_cityscapes_danet_int8.yaml",
    "OCNet": "configs/serve_cityscapes_ocnet_int8.yaml",
}
ATTENTION_OPTS = ["TPU.INT8_RESNET", "False", "TEST.CROP_SIZE", None,
                  "DATASET.NAME", "synthetic"]
# PAM's and CAM's gamma start at 0 in both packages, which makes PAM(x) = x:
# random weights get this value instead, so the attention reaches the logits.
GAMMA = 0.5
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # H100 SXM: 16 exponentials a clock per SM


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def median_ms(torch, fn, n=20, warmup=3, hide_launch=False):
    """Median ms of ``fn`` between two CUDA events. ``hide_launch``: the
    card spins before the first event while the host enqueues ``fn``, so
    that a call of a few microseconds is not timed with its launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_launch:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, n=50, rounds=5):
    """Median over ``rounds`` of the host's microseconds a call of ``fn``
    takes: ``n`` calls enqueued back to back, the card running them after."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
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
            block1=True, wrapper=entrychain.fused_stem_block1, wgmma="stem_block1_wgmma_kernel",
            plain=lambda x: entrychain.fused_stem_block1_plain(x, stem_p, sep_p, skip_p),
            kernel=lambda x: entrychain.fused_stem_block1(x, stem_p, sep_p, skip_p),
            launch=("entry_stem_block1", (stem_p, sep_p, skip_p)),
            replaces="segmentron_tpu/ops/entrychain.py:386 (_stem_block1_kernel; "
                     "fused_stem_block1 :509, pallas_call :583)",
        ),
        "fused_stem": dict(
            block1=False, wrapper=entrychain.fused_stem, wgmma="stem_wgmma_kernel",
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
            ops = entrychain.pack_operands(x, *groups) if dt == torch.bfloat16 else None
            out = torch.empty_like(got)

            def launch():
                entrychain._launch(entry, k["block1"], x, packed, out, ops)
            kernel_ms = median_ms(torch, launch)
            hidden_ms = median_ms(torch, launch, hide_launch=True)
            plain_ms = median_ms(torch, lambda: k["plain"](x))
            bound_ms, bound_by = entry_bound(n, h, w, k["block1"], dname, x.element_size())
            print(f"{card} {name} {dname} {tuple(x.shape)}: max|err| {max_err:.6g} "
                  f"(max|ref| {max_ref:.6g}), mean|err| {mean_err:.6g} (mean|ref| "
                  f"{mean_ref:.6g}) [{rule}: {'ok' if ok else 'FAIL'}]; kernel "
                  f"{kernel_ms:.4f} ms ({hidden_ms:.4f} launch hidden), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            k[dname] = dict(max_abs_err=max_err, ms=kernel_ms, ms_launch_hidden=hidden_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            kernel=k["wgmma"] if dt == torch.bfloat16 else
                            ("stem_block1_kernel<f32>" if k["block1"] else "stem_kernel<f32>"))
    return kernels


# The image shapes whose plans the source and the mirror must agree on: the
# flagship's, two images, a ragged last tile row (H/4 = 260), one tile tall,
# and the Trainer's validation at the 768 crop, two images.
ENTRY_PLAN_SHAPES = [(1, 1024, 2048), (2, 1024, 2048), (1, 1040, 2048), (1, 32, 64),
                     (2, 768, 768)]
# and the stem's: the flagship's, two images, H/2 = 520 (65 tile rows), the
# smallest image, a last tile column of 18 and of 2 pixels (W/2 = 80, 64)
STEM_PLAN_SHAPES = [(1, 1024, 2048), (2, 1024, 2048), (1, 1040, 2048), (1, 32, 32),
                    (1, 48, 160), (2, 64, 128)]


def check_entry_plans(entrychain, card):
    """``stem_block1_wgmma_kernel``'s plan as the source gives it
    (``entry_plan``) against the mirror ``ops/entrychain.py::entry_plan``."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, h, w in ENTRY_PLAN_SHAPES:
        src = entrychain.kernel_entry_plan(n, h, w)
        mirror = entrychain.plan_ints(entrychain.entry_plan(n, h, w, sms=sms))
        print(f"{card} entry plan ({n}, {h}, {w}, 3): {src}"
              + ("" if src == mirror else f" (mirror {mirror})"))
        if src != mirror:
            fail(f"entry_plan differs from the source's at ({n}, {h}, {w}, 3)")
        if src[7] > 232448:
            fail(f"entry_plan: {src[7]} bytes of shared memory")
    for n, h, w in STEM_PLAN_SHAPES:
        src = entrychain.kernel_stem_plan(n, h, w)
        mirror = entrychain.stem_plan_ints(entrychain.stem_plan(n, h, w, sms=sms))
        print(f"{card} stem plan ({n}, {h}, {w}, 3): {src}"
              + ("" if src == mirror else f" (mirror {mirror})"))
        if src != mirror:
            fail(f"stem_plan differs from the source's at ({n}, {h}, {w}, 3)")
        if src[8] > 232448:
            fail(f"stem_plan: {src[8]} bytes of shared memory")


def check_entry_build(card):
    """ptxas's report of ``csrc/entrychain.cu`` (registers and spills of
    every kernel, its warnings) and the SASS of the bf16 kernels:
    ``stem_block1_wgmma_kernel`` must hold HGMMA (wgmma) and UTMALDG (the
    patch's TMA tile load), ``stem_wgmma_kernel`` those and UTMASTG (its
    TMA stores), and neither spill nor draw a ptxas wgmma-serialisation
    warning (C7510-C7520)."""
    import re

    from segmentron_tpu_torch.ops.kernels import _target

    print_ptxas(card, "entrychain")
    spills = ptxas_spills("entrychain", r"kernel")
    print(f"{card} ptxas entrychain spills (stores, loads): {spills}")
    log = _target("entrychain").with_suffix(".log").read_text()
    serial = [ln.strip() for ln in log.splitlines()
              if re.search(r"C75(1\d|20)", ln) and "stem_wgmma_kernel" in ln]
    if serial:
        fail("ptxas serialises wgmma in stem_wgmma_kernel:\n" + "\n".join(serial))
    stem_spills = [v for k, v in spills.items() if "stem_wgmma_kernel" in k]
    if len(stem_spills) != 1 or any(stem_spills[0]):
        fail(f"stem_wgmma_kernel spills, or is missing: {stem_spills}")
    counts = print_sass_mix(card, "entrychain", r"stem(_block1)?_wgmma_kernel", top=14)
    if not counts or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        fail("a bf16 entry kernel lacks HGMMA or UTMALDG instructions")
    if not any("stem_wgmma_kernel" in k and c["UTMASTG"] > 0 for k, c in counts.items()):
        fail("stem_wgmma_kernel lacks UTMASTG instructions")
    return spills


def entry_library(torch, x, stem_p, sep_p=None, skip_p=None):
    """The library route of stem + block1 (of the stem alone without
    ``sep_p``) on ``x`` (NHWC), for timing only: PyTorch's own calls on
    channels-last tensors of x's dtype, F.conv2d (cuDNN) for conv1, conv2,
    the depthwise convs (groups) and the 1x1s, the affines (and ReLUs)
    elementwise. Returns a function giving NHWC."""
    import torch.nn.functional as F

    dt = x.dtype

    def wt(k):  # HWIO -> OIHW, channels-last
        return k.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def ab(a, b):
        return a.to(dt).view(1, -1, 1, 1), b.to(dt).view(1, -1, 1, 1)

    k1, a1, b1, k2, a2, b2 = stem_p
    stem = [(wt(k1), *ab(a1, b1)), (wt(k2), *ab(a2, b2))]
    seps = [((wt(p[0]), *ab(p[1], p[2])), (wt(p[3]), *ab(p[4], p[5]))) for p in sep_p or ()]
    skip = (wt(skip_p[0]), *ab(skip_p[1], skip_p[2])) if sep_p else None

    def run():
        y = x.permute(0, 3, 1, 2)
        (w1, s1, c1), (w2, s2, c2) = stem
        y = torch.relu(F.conv2d(y, w1, stride=2, padding=1) * s1 + c1)
        y = inp = torch.relu(F.conv2d(y, w2, padding=1) * s2 + c2)
        if skip is None:
            return y.permute(0, 2, 3, 1)
        for i, ((dw, sd, cd), (pw, sp, cp)) in enumerate(seps):
            y = F.conv2d(y, dw, stride=2 if i == 2 else 1, padding=1, groups=y.shape[1]) * sd + cd
            y = F.conv2d(y, pw) * sp + cp
        y = y + (F.conv2d(inp, skip[0], stride=2) * skip[1] + skip[2])
        return y.permute(0, 2, 3, 1)
    return run


def baseline_entry_lib(path):
    """The library of another ``entrychain.cu`` at ``path``, with PR 15's C
    interface: ``entry_stem(x, y, prm, n, h, w, bf16, stream)`` (no
    operands: its stem is the first version) and ``entry_stem_block1(x, y,
    prm, ops, n, h, w, bf16, stream)``."""
    import ctypes

    lib = baseline_lib(path, "entrychain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.entry_stem.argtypes = [p, p, p, i, i, i, i, p]
    lib.entry_stem_block1.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.entry_stem.restype = lib.entry_stem_block1.restype = i
    return lib


def compare_entry(torch, entrychain, card, dev, gen, path):
    """At (1, 1024, 2048, 3), the baseline source ``path`` (another
    ``entrychain.cu``, PR 15's interface) and this one on the same image and
    weights in turns old, new, new, old: the stem in bf16 and f32, stem +
    block1 in bf16; each turn the median of 20 with the launch not hidden,
    hidden behind a spin of the card, and the host's microseconds a call;
    max|old - new| and each against the plain version (phase 3's bars).
    Returns {"<entry> <dtype>": {"old": [ms, ms], "new": ..., ...}}."""
    old_lib, new_lib = baseline_entry_lib(path), entrychain._lib()
    stem_p, sep_p, skip_p = entry_params(torch, gen, dev)
    x32 = torch.randn(SHAPE, generator=gen).to(dev)
    n, h, w, _ = SHAPE
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for entry, dt in (("entry_stem", torch.bfloat16), ("entry_stem", torch.float32),
                      ("entry_stem_block1", torch.bfloat16)):
        dname = dtype_name(dt)
        block1 = entry == "entry_stem_block1"
        groups = (stem_p, sep_p, skip_p) if block1 else (stem_p,)
        x = x32.to(dt)
        prm = entrychain.pack_weights(x, *groups)
        ops = entrychain.pack_operands(x, *groups)
        stride, cout = (4, 128) if block1 else (2, 64)
        outs = {v: torch.empty((n, h // stride, w // stride, cout), dtype=dt, device=dev)
                for v in ("old", "new")}

        def run(ver):
            bufs = (x.data_ptr(), outs[ver].data_ptr(), prm.data_ptr())
            if ver == "new" or block1:  # the old stem reads no operands
                bufs += (ops.data_ptr(),)
            lib = old_lib if ver == "old" else new_lib
            rc = getattr(lib, entry)(*bufs, n, h, w, int(dt == torch.bfloat16), stream)
            if rc != 0:
                fail(f"{ver} {entry} {dname}: error {rc}")

        times = {k: [] for k in ("old", "new", "old_hidden", "new_hidden", "old_host_us",
                                 "new_host_us")}
        for ver in ("old", "new", "new", "old"):
            times[ver].append(median_ms(torch, lambda: run(ver)))
            times[ver + "_hidden"].append(median_ms(torch, lambda: run(ver), hide_launch=True))
            times[ver + "_host_us"].append(host_us(torch, lambda: run(ver)))
        torch.cuda.synchronize()
        ref = (entrychain.fused_stem_block1_plain(x, *groups) if block1
               else entrychain.fused_stem_plain(x, *stem_p)).float()
        errs = {}
        for ver, y in outs.items():
            e = (y.float() - ref).abs()
            errs[ver] = (e.max().item(), e.mean().item())
        diff = (outs["old"].float() - outs["new"].float()).abs().max().item()
        mean = {k: statistics.mean(v) for k, v in times.items()}

        def turns(key, fmt):
            return " ".join(f"{t:{fmt}}" for t in times[key])
        print(f"{card} {entry} {dname} {SHAPE}: baseline {path} against this source, "
              f"old/new/new/old: old {turns('old', '.4f')} ms, new {turns('new', '.4f')} ms, "
              f"old / new {mean['old'] / mean['new']:.2f}; launch hidden: old "
              f"{turns('old_hidden', '.4f')} ms, new {turns('new_hidden', '.4f')} ms, old / new "
              f"{mean['old_hidden'] / mean['new_hidden']:.2f}; host a call: old "
              f"{turns('old_host_us', '.2f')} us, new {turns('new_host_us', '.2f')} us; "
              f"max|old - new| {diff:.6g}; against the plain version (max|err|, mean|err|; "
              f"max|ref| {ref.abs().max().item():.6g}, mean|ref| {ref.abs().mean().item():.6g}): "
              f"old {errs['old'][0]:.6g} {errs['old'][1]:.6g}, new {errs['new'][0]:.6g} "
              f"{errs['new'][1]:.6g}")
        results[f"{entry} {dname}"] = dict(times, max_old_new=diff, err_old=errs["old"],
                                           err_new=errs["new"])
        del x, prm, ops, outs, ref
        torch.cuda.empty_cache()
    return results


def entry_small_cases(torch, entrychain, card, dev, gen):
    """The bf16 stem + block1 and the bf16 stem at small images against the
    plain version, each output pixel's largest error over its channels
    printed as a grid for the first image: where a halo or an edge goes
    wrong shows as whole rows or columns. Stem + block1: one tile tall, a
    ragged tile row, two images; the stem: the smallest image, a ragged
    last tile column of 18 pixels, one of 2 pixels and two images, and
    three tile columns. Returns the cases that miss phase 3's bf16 bar."""
    stem_p, sep_p, skip_p = entry_params(torch, gen, dev)
    groups = (stem_p, sep_p, skip_p)
    cases = [("stem_block1", shape, lambda x: entrychain.fused_stem_block1(x, *groups),
              lambda x: entrychain.fused_stem_block1_plain(x, *groups))
             for shape in [(1, 32, 64), (1, 48, 128), (2, 64, 128)]]
    cases += [("stem", shape, lambda x: entrychain.fused_stem(x, *stem_p),
               lambda x: entrychain.fused_stem_plain(x, *stem_p))
              for shape in [(1, 32, 32), (1, 48, 160), (2, 64, 128), (1, 32, 256)]]
    bad = []
    for name, (n, h, w), kernel, plain in cases:
        x = torch.randn(n, h, w, 3, generator=gen).to(dev, torch.bfloat16)
        got = kernel(x).float()
        ref = plain(x).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = (bool(torch.isfinite(got).all())
              and err.max().item() <= 3e-2 * ref.abs().max().item()
              and err.mean().item() <= 2e-3 * ref.abs().mean().item())
        grid = err[0].amax(-1) / ref.abs().max()
        print(f"{card} entry {name} bfloat16 ({n}, {h}, {w}, 3): max|err| "
              f"{err.max().item():.6g} (max|ref| {ref.abs().max().item():.6g}), mean|err| "
              f"{err.mean().item():.6g} [{'ok' if ok else 'FAIL'}]; per pixel, x100 of max|ref|:\n"
              + "\n".join(" ".join(f"{100 * v:3.0f}" for v in row) for row in grid.tolist()))
        if not ok:
            bad.append((name, n, h, w))
    return bad


def entry_only(torch, entrychain, card):
    """``--entry``: build ``csrc/entrychain.cu`` alone, check its ptxas
    report, SASS and plans, run phase 3's entry checks (both kernels, both
    dtypes), time the library route, and with ``--baseline=<path>`` another
    source in turns."""
    from segmentron_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build(["entrychain"])
    print(f"{card} build entrychain: {time.perf_counter() - t0:.2f} s")
    results = {"spills": check_entry_build(card)}
    check_entry_plans(entrychain, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    bad = entry_small_cases(torch, entrychain, card, dev, gen)
    if bad:
        fail(f"a bf16 entry kernel disagrees with its plain version at {bad}")
    kernels = check_entry_kernels(torch, entrychain, card, dev, gen)
    results["kernels"] = {name: {d: k[d] for d in ("float32", "bfloat16")}
                          for name, k in kernels.items()}
    stem_p, sep_p, skip_p = entry_params(torch, gen, dev)
    x = torch.randn(SHAPE, generator=gen).to(dev, torch.bfloat16)
    routes = {
        "stem_block1": (entry_library(torch, x, stem_p, sep_p, skip_p),
                        lambda: entrychain.fused_stem_block1_plain(x, stem_p, sep_p, skip_p)),
        "stem": (entry_library(torch, x, stem_p),
                 lambda: entrychain.fused_stem_plain(x, *stem_p)),
    }
    results["library_route"] = {}
    for name, (lib_fn, plain) in routes.items():
        with torch.inference_mode():
            got = lib_fn().float()
            ref = plain().float()
            lib_ms = median_ms(torch, lib_fn)
            lib_hidden = median_ms(torch, lib_fn, hide_launch=True)
        print(f"{card} entry {name} library route bfloat16 {SHAPE} (cuDNN convs, the affines "
              f"elementwise): {lib_ms:.4f} ms ({lib_hidden:.4f} launch hidden); max|err| against "
              f"the plain version {(got - ref).abs().max().item():.6g} (max|ref| "
              f"{ref.abs().max().item():.6g})")
        results["library_route"][name] = dict(ms=lib_ms, ms_launch_hidden=lib_hidden)
    for arg in sys.argv[1:]:
        if arg.startswith("--baseline="):
            results["baseline"] = compare_entry(torch, entrychain, card, dev, gen,
                                                arg.split("=", 1)[1])
    print(json.dumps(results))
    return 0


# Probe builds of csrc/entrychain.cu (--entry-probe): a part of
# stem_block1_wgmma_kernel left out, wrong results, times only.
ENTRY_BUILDS = {
    "full": (),
    "no taps": ("-DENTRY_NO_TAPS",),
    "no products": ("-DENTRY_NO_MMA",),
    "no epilogues": ("-DENTRY_NO_EPI",),
    "no weight loads": ("-DENTRY_NO_WLOAD",),
    "no patch loads": ("-DENTRY_NO_IMG",),
    "no taps, products, epilogues": ("-DENTRY_NO_TAPS", "-DENTRY_NO_MMA", "-DENTRY_NO_EPI"),
}


# Probe builds of csrc/entrychain.cu (--entry-probe): a part of
# stem_wgmma_kernel left out, wrong results, times only.
STEM_BUILDS = {
    "full": (),
    "no products": ("-DSTEM_NO_MMA",),
    "no epilogues": ("-DSTEM_NO_EPI",),
    "no stores": ("-DSTEM_NO_STORE",),
    "no patch loads": ("-DSTEM_NO_IMG",),
    "no products, epilogues, stores": ("-DSTEM_NO_MMA", "-DSTEM_NO_EPI", "-DSTEM_NO_STORE"),
}


def entry_probe(torch, entrychain, card):
    """``--entry-probe[=stem|block1]``: the bf16 kernels and their probe
    builds (``STEM_BUILDS`` for ``stem_wgmma_kernel``, ``ENTRY_BUILDS`` for
    ``stem_block1_wgmma_kernel``; both without a choice), built in
    parallel, at (1, 1024, 2048, 3), timed in turns (each build, then each
    again in reverse order; median of 20, launches hidden), with ptxas's
    registers and spills of each."""
    from segmentron_tpu_torch.ops import kernels

    which = next((a.partition("=")[2] for a in sys.argv[1:] if a.startswith("--entry-probe=")),
                 "")
    tables = {"stem": (STEM_BUILDS, False, "stem_wgmma_kernel"),
              "block1": (ENTRY_BUILDS, True, "stem_block1_wgmma_kernel")}
    if which:
        tables = {which: tables[which]}
    builds = {}
    for name, (table, _, _) in tables.items():
        builds.update({f"{name} {b}" if b != "full" else "full": f for b, f in table.items()})
    loaded = probe_libs(card, "entrychain", builds, entrychain._lib,
                        ptxas=r"stem(_block1)?_wgmma_kernel")
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    stem_p, sep_p, skip_p = entry_params(torch, gen, dev)
    x = torch.randn(SHAPE, generator=gen).to(dev, torch.bfloat16)
    results = {}
    for name, (table, block1, kernel) in tables.items():
        groups = (stem_p, sep_p, skip_p) if block1 else (stem_p,)
        packed = (entrychain.pack_weights(x, *groups), entrychain.pack_operands(x, *groups))
        stride, cout = (4, 128) if block1 else (2, 64)
        out = torch.empty((1, SHAPE[1] // stride, SHAPE[2] // stride, cout), dtype=x.dtype,
                          device=dev)
        entry = "entry_stem_block1" if block1 else "entry_stem"
        names = [f"{name} {b}" if b != "full" else "full" for b in table]
        times = {}
        for b in [*names, *reversed(names)]:
            kernels._loaded["entrychain"] = loaded[b]
            times.setdefault(b, []).append(median_ms(
                torch, lambda: entrychain._launch(entry, block1, x, packed[0], out, packed[1]),
                hide_launch=True))
        torch.cuda.synchronize()
        kernels._loaded["entrychain"] = loaded["full"]
        print(f"{card} {kernel} bfloat16 {SHAPE} probe builds, ms (in turns, launch hidden): "
              + "; ".join(f"{b} {' '.join(f'{t:.4f}' for t in v)}" for b, v in times.items()))
        results[name] = times
    print(json.dumps({"times": results}))
    return 0


def probe_libs(card, source, builds, lib_fn, ptxas=None):
    """{build: the library of ``csrc/<source>.cu`` built with that build's
    flags} for ``builds`` ({name: flags}, "full" among them), compiled at
    once by ``kernels.build_variants``, each loaded and given its argument
    types by ``lib_fn`` (the ops module's ``_lib``); with ``ptxas`` (a
    regex), ptxas's report of the matching kernels of each build. Leaves
    the full build loaded."""
    import ctypes

    from segmentron_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    try:
        paths = kernels.build_variants(source, builds)
    except RuntimeError as e:
        fail(f"probe builds of {source}.cu: {e}")
    print(f"{card} probe builds of {source}.cu: {time.perf_counter() - t0:.2f} s")
    loaded = {}
    for name, path in paths.items():
        if ptxas:
            print_ptxas(card, f"{source} {name}", log=path.with_suffix(".log"), only=ptxas)
        kernels._loaded[source] = ctypes.CDLL(str(path))
        loaded[name] = lib_fn()
    kernels._loaded[source] = loaded["full"]
    return loaded


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
    # 1536 channels: beyond what the resident kernel holds in shared memory
    # (its recompute variant took them); the wgmma kernel takes them now
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
    kernel) against the plain version, and their times. Returns {entry
    point: {dtype: the main case's numbers, "cases": {what: {dtype:
    numbers}}}}, each with the kernel the source picked."""
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
            launch = lambda: sepconv._launch(x, packed, **launch_kw)  # noqa: E731
            kernel_ms = median_ms(torch, launch)
            hidden_ms = median_ms(torch, launch, hide_launch=True)
            launch_us = host_us(torch, launch)
            plain_ms = median_ms(torch, lambda: plain(*args, **kw), n=10, warmup=1)
            bound_ms, bound_by = sepconv_bound(case, x.element_size(), dname)
            print(f"{card} {case['fn']} {dname} {case['what']} {tuple(x.shape)} -> "
                  f"{tuple(got.shape)} d={case['d']} int8_dot={case['int8']}: max|err| "
                  f"{max_err:.6g} (max|ref| {max_ref:.6g}, int8 step {step:.6g}), mean|err| "
                  f"{mean_err:.6g} (mean|ref| {mean_ref:.6g}) [{rule}: "
                  f"{'ok' if ok else 'FAIL'}]; kernel {kernel_ms:.4f} ms (launch hidden "
                  f"{hidden_ms:.4f} ms; host {launch_us:.2f} us a call), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                fail(f"{case['fn']} {dname} ({case['what']}) disagrees with its plain version")
            n, h, w, c = x.shape
            plan = sepconv.kernel_plan(n, h, w, c, case["co"], case["d"], case.get("stride", 1),
                                       case.get("skip"), dt, case["int8"], case.get("cin", 0))
            entry = dict(max_abs_err=max_err, ms=kernel_ms, ms_launch_hidden=hidden_ms,
                         host_us=launch_us, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, shape=list(x.shape), what=case["what"],
                         kernel=f"sepconv_{plan['kernel']}_kernel"
                         if plan["kernel"] != "recompute" else "sepconv_kernel")
            by_fn = results.setdefault(case["fn"], {})
            by_fn.setdefault("cases", {}).setdefault(case["what"], {})[dname] = entry
            if case.get("main"):
                by_fn[dname] = entry
            del args, roles, ref, got, err, packed, x
    return results


# The flagship's fused layers at 1024x2048, batch 1, bf16: (entry point,
# (N, H, W, C) of the layer's input, Co, dilation, stride, skip, int8_dot,
# launches a forward). Path A (output stride 16; the first two run only with
# the entry kernel off, FUSED_STEM False) and path B (output stride 8), as
# a forward records them (tests/test_torch_sepconv_plan.py derives them on
# the meta device).
FLAGSHIP_SEPCONV_LAYERS = [
    ("fused_sepconv_infer_v2", (1, 512, 1024, 64), 128, 1, 1, None, False, 1),
    ("fused_sepconv_infer_v2", (1, 512, 1024, 128), 128, 1, 1, None, False, 1),
    ("fused_sepconv_infer_v2", (1, 256, 512, 128), 256, 1, 1, None, False, 1),
    ("fused_sepconv_infer_v2", (1, 256, 512, 256), 256, 1, 1, None, False, 2),
    ("fused_sepconv_infer_v2", (1, 128, 256, 256), 728, 1, 1, None, False, 1),
    ("fused_sepconv_infer_v2", (1, 64, 128, 728), 728, 1, 1, None, False, 49),
    ("fused_sepconv_infer_v2", (1, 64, 128, 728), 1024, 1, 1, None, False, 1),
    ("fused_sepconv_infer_v2", (1, 256, 512, 304), 256, 1, 1, None, False, 1),
    ("fused_sepconv_infer_v3", (1, 256, 512, 128), 256, 1, 1, None, True, 1),
    ("fused_sepconv_infer_v3", (1, 256, 512, 256), 256, 1, 1, None, True, 1),
    ("fused_sepconv_infer_v3", (1, 128, 256, 256), 728, 1, 1, None, True, 1),
    ("fused_sepconv_infer_v3", (1, 128, 256, 728), 728, 1, 1, None, True, 1),
    ("fused_sepconv_infer_v3", (1, 128, 256, 728), 728, 2, 1, None, True, 32),
    ("fused_sepconv_infer_v3_skip", (1, 256, 512, 256), 256, 1, 2, "conv", True, 1),
    ("fused_sepconv_infer_v3_skip", (1, 128, 256, 728), 728, 1, 1, "conv", True, 1),
    ("fused_sepconv_infer_v3_skip", (1, 128, 256, 728), 728, 2, 1, "sum", True, 16),
]


def check_sepconv_plans(torch, sepconv, card):
    """The kernel, tiles, grid, Co split and shared memory as the source
    picks them (``sepconv_plan``) against the mirror
    ``ops/sepconv.py::sepconv_plan``, at every ``SEPCONV_CASES`` case in
    f32 and bf16 and at the flagship's layers; every bf16 stride-1 case,
    block ends with their sum or conv skip included, takes the wgmma kernel,
    and stride 2 and f32 keep the older kernels' routes."""
    # the flagship's conv-skip layers: cin 128 (block2) or 256 (block3); the
    # plan reads cin only through cin % 8
    shapes = [(c["fn"], c["what"], c["shape"], c["co"], c["d"], c.get("stride", 1),
               c.get("skip"), c["int8"], dt, c.get("cin", 0))
              for c in SEPCONV_CASES for dt in (torch.float32, torch.bfloat16)]
    shapes += [(fn, f"flagship layer x{count}", shape, co, d, stride, skip, int8,
                torch.bfloat16, 128 if skip == "conv" else 0)
               for fn, shape, co, d, stride, skip, int8, count in FLAGSHIP_SEPCONV_LAYERS]
    for fn, what, shape, co, d, stride, skip, int8, dt, cin in shapes:
        n, h, w, c = shape
        kw = dict(stride=stride, skip=skip, dtype=dt, int8_dot=int8, cin=cin)
        src = sepconv.kernel_plan(n, h, w, c, co, d, **kw)
        mirror = sepconv.sepconv_plan(n, h, w, c, co, d, sms=torch.cuda.get_device_properties(
            0).multi_processor_count, **kw)
        dname = dtype_name(dt)
        print(f"{card} sepconv plan {fn} {dname} {what} {shape} -> {co} d={d} stride={stride} "
              f"skip={skip} int8_dot={int8}: {src}{'' if src == mirror else f' (mirror {mirror})'}")
        if src != mirror:
            fail(f"sepconv_plan differs from the source's for {fn} {dname} {what}")
        if src["smem"] > 232448:
            fail(f"sepconv_plan: {src['smem']} bytes of shared memory for {fn} {what}")
        if (src["kernel"] == "wgmma") != (dt == torch.bfloat16 and stride == 1):
            fail(f"{fn} {dname} {what} takes {src['kernel']}: bf16 stride-1 calls take the "
                 "wgmma kernel, stride 2 and f32 the older kernels")


def check_sepconv_wgmma_cases(results):
    """Every bf16 stride-1 case of ``SEPCONV_CASES`` ran on
    ``sepconv_wgmma_kernel`` (the v3 and v2 main cases, the middle-flow
    sum-skip and block3's conv-skip block ends among them); ``results`` as
    ``check_sepconv_kernels`` returns them."""
    for case in SEPCONV_CASES:
        if case.get("stride", 1) != 1:
            continue
        got = results[case["fn"]]["cases"][case["what"]]["bfloat16"]["kernel"]
        if got != "sepconv_wgmma_kernel":
            fail(f"{case['fn']} bf16 {case['what']} does not take sepconv_wgmma_kernel: {got}")


def baseline_sepconv_lib(path):
    """The library of another ``sepconv.cu`` at ``path`` (same
    ``sepconv_launch``)."""
    import ctypes

    lib = baseline_lib(path, "sepconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sepconv_launch.argtypes = [p] * 8 + [i] * 12 + [p]
    lib.sepconv_launch.restype = i
    return lib


def compare_sepconv(torch, sepconv, card, dev, gen, path):
    """At each case in f32 and bf16, the baseline source ``path`` (another
    ``sepconv.cu``) and this one on the same packed weights, each median
    of 20, in turns old, new, new, old; the baseline's result held to this
    source's at the case's bar (check_sepconv_kernels'). Each turn takes the
    time as phase 3 does (launch not hidden), with the launch hidden, and
    the host's microseconds a call. Returns {fn: {what: {dtype: {"old": [ms,
    ms], "new": [ms, ms], "old_hidden": ..., "new_hidden": ...,
    "old_host_us": ..., "new_host_us": ...}}}}."""
    old_lib, new_lib = baseline_sepconv_lib(path), sepconv._lib()
    results = {}
    for case in SEPCONV_CASES:
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            _, _, roles = sepconv_inputs(torch, sepconv, case, dt, gen, dev)
            x, x_in, skip = roles["x"], roles["x_in"], case.get("skip")
            packed = sepconv.pack_sepconv(x, *roles["weights"], case["int8"],
                                          *roles["skip_weights"])
            kw = dict(dilation=case["d"], pre_relu=case["relu"], stride=case.get("stride", 1),
                      skip=skip, x_in=x_in)
            new = sepconv._launch(x, packed, **kw)
            old = torch.empty_like(new)
            libs = {"old": (old_lib, old), "new": (new_lib, new)}

            def run(ver):  # both sources' C entry alike, each into its own output
                lib, out = libs[ver]
                n, h, w, c = x.shape
                conv = skip == "conv"
                rc = lib.sepconv_launch(
                    x.data_ptr(), x_in.data_ptr() if skip else None, out.data_ptr(),
                    packed.dwp.data_ptr(), packed.pw.data_ptr(), packed.osb.data_ptr(),
                    packed.skw.data_ptr() if conv else None,
                    packed.ska.data_ptr() if conv else None, n, h, w, c, packed.co,
                    packed.cin if conv else 0, case["d"], case.get("stride", 1),
                    int(case["relu"]), sepconv._SKIP_CODES[skip], int(dt == torch.bfloat16),
                    int(case["int8"]), torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    fail(f"{ver} sepconv_launch: error {rc}")

            times = {k: [] for k in ("old", "new", "old_hidden", "new_hidden", "old_host_us",
                                     "new_host_us")}
            for ver in ("old", "new", "new", "old"):
                times[ver].append(median_ms(torch, lambda: run(ver)))
                times[ver + "_hidden"].append(median_ms(torch, lambda: run(ver),
                                                        hide_launch=True))
                times[ver + "_host_us"].append(host_us(torch, lambda: run(ver)))
            torch.cuda.synchronize()
            err = (old.float() - new.float()).abs()
            ref = new.float().abs()
            step = 127.0 * roles["weights"][4].abs().max().item() if case["int8"] else 0.0
            if dt == torch.float32:
                ok = err.max().item() <= 1e-4 * ref.max().item() + 2 * step
            else:
                ok = (err.max().item() <= 3e-2 * ref.max().item() + 2 * step
                      and err.mean().item() <= 2e-3 * ref.mean().item())
            if not ok:
                fail(f"baseline sepconv {case['fn']} {dname} {case['what']}: results differ "
                     f"beyond the bar (max|err| {err.max().item():.6g})")
            mean = {k: statistics.mean(v) for k, v in times.items()}

            def turns(key, fmt):
                return " ".join(f"{t:{fmt}}" for t in times[key])
            print(f"{card} sepconv {case['fn']} {dname} {case['what']} {tuple(x.shape)} -> "
                  f"{case['co']}: baseline {path} against this source, old/new/new/old: old "
                  f"{turns('old', '.4f')} ms, new {turns('new', '.4f')} ms, old / new "
                  f"{mean['old'] / mean['new']:.2f}; launch hidden: old "
                  f"{turns('old_hidden', '.4f')} ms, new {turns('new_hidden', '.4f')} ms, "
                  f"old / new {mean['old_hidden'] / mean['new_hidden']:.2f}; host a call: old "
                  f"{turns('old_host_us', '.2f')} us, new {turns('new_host_us', '.2f')} us; "
                  f"max|old - new| {err.max().item():.6g}")
            results.setdefault(case["fn"], {}).setdefault(case["what"], {})[dname] = times
            del x, x_in, roles, packed, new, old, err, ref
        torch.cuda.empty_cache()
    return results


# sepconv_wgmma_kernel<DOT, N, D, SKIP>: s8 or bf16 products, N 192 or 128,
# dilation 1 or 2, no skip, the conv skip or the sum skip
SEPCONV_WGMMA_SPECS = 2 * 2 * 2 * 3


def check_sepconv_build(card):
    """ptxas's report of ``csrc/sepconv.cu`` (registers and spills of each
    kernel, its warnings) and the wgmma kernel's SASS: each specialisation
    must hold HGMMA (bf16) or IGMMA (s8) and UTMALDG, and neither spill nor
    draw a wgmma-serialisation warning (C7510-C7520)."""
    import re

    from segmentron_tpu_torch.ops.kernels import _target

    print_ptxas(card, "sepconv")
    log = _target("sepconv").with_suffix(".log").read_text()
    serial = [ln.strip() for ln in log.splitlines() if re.search(r"C75(1\d|20)", ln)]
    if serial:
        fail("ptxas serialises wgmma in csrc/sepconv.cu:\n" + "\n".join(serial))
    spills = ptxas_spills("sepconv", r"sepconv_wgmma_kernel")
    print(f"{card} ptxas sepconv sepconv_wgmma_kernel spills (stores, loads): {spills}")
    if len(spills) != SEPCONV_WGMMA_SPECS or any(st or ld for st, ld in spills.values()):
        fail(f"the wgmma sepconv kernel spills, or lacks a specialisation: {spills}")
    counts = print_sass_mix(card, "sepconv", r"sepconv_wgmma_kernel", top=12)
    if not counts or len(counts) != SEPCONV_WGMMA_SPECS or any(
            c["HGMMA"] + c["IGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        fail("a wgmma sepconv kernel lacks HGMMA/IGMMA or UTMALDG instructions")


def default_layer_ms(torch, card, dev, gen):
    """The default route's own layer at the shapes of the main v3 and v2
    cases, bf16, channels-last, each median of 20 (CUDA events, launches
    hidden): ``SeparableConv2d`` unfused (ReLU, cuDNN's depthwise conv, the
    BN affine, the 1x1 conv, its BN affine) and each piece alone. Returns
    {what: {piece: ms}}."""
    import torch.nn.functional as F

    from segmentron_tpu_torch.modules import SeparableConv2d

    results = {}
    for case in SEPCONV_CASES:
        if not case.get("main") or case.get("skip") or case["fn"] == "fused_sepconv_infer":
            continue
        n, h, w, c = case["shape"]
        m = SeparableConv2d(c, case["co"], dilation=case["d"], relu_first=case["relu"])
        m = m.to(dev).eval().to(memory_format=torch.channels_last)
        for conv in (m.depthwise, m.pointwise):  # the norms keep f32 statistics, as the model's
            conv.to(torch.bfloat16)
        x = torch.randn(n, c, h, w, generator=gen).to(dev, torch.bfloat16).to(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            dw = m.depthwise(x.relu())
            y = m.dw_bn(dw)
            pw = m.pointwise(y)
            pieces = {"layer": lambda: m(x), "relu": lambda: x.relu(),
                      "depthwise (cuDNN)": lambda: m.depthwise(x),
                      "affine": lambda: m.dw_bn(dw), "1x1 conv": lambda: m.pointwise(y),
                      "affine after": lambda: m.pw_bn(pw),
                      "1x1 as a matmul": lambda: torch.matmul(
                          y.permute(0, 2, 3, 1).reshape(-1, c),
                          m.pointwise.weight.reshape(case["co"], c).t())}
            times = {k: median_ms(torch, fn, hide_launch=True) for k, fn in pieces.items()}
        print(f"{card} default route's layer at {case['fn']}'s {case['what']} {case['shape']} -> "
              f"{case['co']} d={case['d']}, bf16: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items()))
        results[case["what"]] = times
        del m, x, dw, y, pw
    return results


# Probe builds of csrc/sepconv.cu's wgmma kernel (--sepconv-probe): a phase
# left out, wrong results, times only.
SEPCONV_BUILDS = {
    "full": (),
    "no taps": ("-DSEPCONV_WG_NO_TAPS",),
    "no products": ("-DSEPCONV_WG_NO_MMA",),
    "neither": ("-DSEPCONV_WG_NO_TAPS", "-DSEPCONV_WG_NO_MMA"),
    "neither, no input box": ("-DSEPCONV_WG_NO_TAPS", "-DSEPCONV_WG_NO_MMA", "-DSEPCONV_WG_NO_X"),
    "neither, no weights": ("-DSEPCONV_WG_NO_TAPS", "-DSEPCONV_WG_NO_MMA", "-DSEPCONV_WG_NO_W"),
    "neither, no loads": ("-DSEPCONV_WG_NO_TAPS", "-DSEPCONV_WG_NO_MMA", "-DSEPCONV_WG_NO_X",
                          "-DSEPCONV_WG_NO_W"),
    "no skip": ("-DSEPCONV_WG_NO_SKIP",),  # a block end's plan without its x_in and skip
}


def sepconv_probe(torch, sepconv, card):
    """``--sepconv-probe``: the wgmma kernel and its probe builds
    (``SEPCONV_BUILDS``, built in parallel) at the bf16 stride-1 main
    cases and block ends, timed in turns (each build, then each again in
    reverse order; median of 20 each, launches hidden)."""
    from segmentron_tpu_torch.ops import kernels

    loaded = probe_libs(card, "sepconv", SEPCONV_BUILDS, sepconv._lib)
    dev, gen, results = torch.device("cuda"), torch.Generator().manual_seed(0), {}
    for case in SEPCONV_CASES:
        if case.get("stride", 1) != 1 or not (case.get("main") or case.get("skip")):
            continue
        _, _, roles = sepconv_inputs(torch, sepconv, case, torch.bfloat16, gen, dev)
        x = roles["x"]
        packed = sepconv.pack_sepconv(x, *roles["weights"], case["int8"], *roles["skip_weights"])
        kw = dict(dilation=case["d"], pre_relu=case["relu"], skip=case.get("skip"),
                  x_in=roles["x_in"])
        times = {}
        for name in [*loaded, *reversed(loaded)]:
            kernels._loaded["sepconv"] = loaded[name]
            times.setdefault(name, []).append(median_ms(
                torch, lambda: sepconv._launch(x, packed, **kw), hide_launch=True))
        torch.cuda.synchronize()
        print(f"{card} {case['fn']} bfloat16 {case['what']} probe builds, ms (in turns): "
              + "; ".join(f"{b} {' '.join(f'{t:.4f}' for t in v)}" for b, v in times.items()))
        results.setdefault(case["fn"], {})[case["what"]] = times
        del x, roles, packed
    kernels._loaded["sepconv"] = loaded["full"]
    print(json.dumps(results))
    return 0


def sepconv_only(torch, sepconv, card):
    """``--sepconv``: build ``csrc/sepconv.cu`` alone, check its ptxas
    report, SASS and plans, check every case in both dtypes, optionally
    against a baseline source."""
    from segmentron_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build(["sepconv"])
    print(f"{card} build sepconv: {time.perf_counter() - t0:.2f} s")
    check_sepconv_build(card)
    check_sepconv_plans(torch, sepconv, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    results = {"sepconv": check_sepconv_kernels(torch, sepconv, card, dev, gen)}
    results["default_layer_ms"] = default_layer_ms(torch, card, dev, gen)
    for arg in sys.argv[1:]:
        if arg.startswith("--baseline="):
            results["baseline"] = compare_sepconv(torch, sepconv, card, dev, gen,
                                                  arg.split("=", 1)[1])
    print(json.dumps(results))
    return 0


# ----------------------------------------------------------- flash attention
# The shapes the path gives the kernel at 1024x2048, output stride 8
# (c4 128x256, P = 32768), the train shapes (576x576 crops, c4 72x72,
# P = 5184, batch 16), and two small ragged cases that run the kernel's
# other value widths (128, 256). ``main``: the line's.
FLASH_CASES = [
    dict(what="DANet PAM", n=1, p=32768, dk=64, dv=512, scale=1.0, main=True),
    dict(what="OCNet base / pyramid level 1", n=1, p=32768, dk=256, dv=512, scale=256 ** -0.5),
    dict(what="OCNet pyramid level 2", n=4, p=8192, dk=256, dv=512, scale=256 ** -0.5),
    dict(what="OCNet pyramid level 3", n=9, p=3698, dk=256, dv=512, scale=256 ** -0.5),
    dict(what="DANet PAM, train", n=16, p=5184, dk=64, dv=512, scale=1.0),
    dict(what="OCNet base, train", n=16, p=5184, dk=256, dv=512, scale=256 ** -0.5),
    dict(what="ragged", n=2, p=600, dk=32, dv=128, scale=1.0),
    dict(what="ragged, Dv 256", n=1, p=1000, dk=48, dv=256, scale=48 ** -0.5),
]


def flash_bound(case, itemsize, dname):
    """(ms, 'bytes' | 'operations', exp ms): q, k, v read once, out and
    lse written once; both products at the peak of their type; the
    exponentials on the special-function units, stated beside."""
    n, p, dk, dv = case["n"], case["p"], case["dk"], case["dv"]
    t_ops = 2 * n * p * p * (dk + dv) / PEAK_OPS[dname]
    t_bytes = (n * p * (2 * dk + 2 * dv) * itemsize + n * p * 4) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * n * p * p / SFU_EXP_PER_S)


def flash_split_bound(case, dname):
    """(ms with the Dv split, ms without) of the kernel's own work at the
    bf16 peak. bf16: 2 N P^2 (split Dk + Dv), s = q . k^T recomputed for
    each of the ``split`` blocks Dv is split over (``fwd_plan``); f32: the
    six products of pieces for s, 2 N P^2 6 split Dk at the bf16 peak, and
    p . v on the FMA units, 2 N P^2 Dv at the f32 peak, which run at once:
    the larger of the two (at Dk > 128 the f32 kernel does not split
    Dv). Without the split (split = 1): bf16 the true bound, f32 the least
    time of its arithmetic."""
    n, p, dk, dv = case["n"], case["p"], case["dk"], case["dv"]
    split = 1 if dname == "float32" and dk > 128 else max(1, dv // 256)
    if dname == "float32":
        pv = 1e3 * 2 * n * p * p * dv / PEAK_OPS["float32"]
        return tuple(max(1e3 * 2 * n * p * p * 6 * sp * dk / PEAK_OPS["bfloat16"], pv)
                     for sp in (split, 1))
    return tuple(1e3 * 2 * n * p * p * (sp * dk + dv) / PEAK_OPS["bfloat16"]
                 for sp in (split, 1))


def flash_pieces_bound(case):
    """(ms, 'bytes') of the f32 route's split pass: q and k read once in
    f32, their three bf16 pieces each written once."""
    n, p, dk = case["n"], case["p"], case["dk"]
    return 1e3 * n * p * (2 * dk * 4 + 3 * 2 * dk * 2) / PEAK_BYTES, "bytes"


def sdpa_library(torch, q, k, v, scale):
    """(ms, backend) of ``F.scaled_dot_product_attention`` on the same
    inputs (one head), or (None, the reason it refused)."""
    from torch.nn.attention import SDPBackend

    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    names = {int(getattr(SDPBackend, n)): n for n in dir(SDPBackend) if n.isupper()}
    backend = names.get(int(torch._fused_sdp_choice(q4, k4, v4, scale=scale)), "?")

    def call():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    try:
        call()
    except RuntimeError as e:
        return None, f"{backend}: refused: {str(e).splitlines()[0][:160]}"
    return median_ms(torch, call, n=10, warmup=2), backend


def check_flash_kernel(torch, attention, card, dev, gen):
    """Every case in f32 and bf16: the wrapper (which launches the kernel,
    in f32 after the split pass) against the plain version over key blocks
    of the kernel's tile (``fwd_plan``), so that bf16's p rounds at the same
    running max; in f32 the split pass's pieces bitwise against
    ``split_pieces_plain``; times of the kernel (in f32 the route, split pass
    and kernel, and each alone), the plain version and
    ``scaled_dot_product_attention``. Returns {case: {dtype: ...}}, the
    split pass's numbers under f32's "pieces"."""
    results = {}
    for case in FLASH_CASES:
        n, p, dk, dv = case["n"], case["p"], case["dk"], case["dv"]
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            block_k = attention.fwd_plan(dk, dv, dt)["tile"]
            q, k = (torch.randn(n, p, dk, generator=gen).to(dev, dt) for _ in range(2))
            v = torch.randn(n, p, dv, generator=gen).to(dev, dt)
            scale = case["scale"]
            ref, ref_lse = attention.flash_attention_plain(q, k, v, scale, block_k=block_k)
            before = attention.flash_attention.launches
            before_split = attention.flash_attention_split.launches
            got, lse = attention.flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            split_launches = 1 if dt == torch.float32 else 0
            if (attention.flash_attention.launches != before + 1
                    or attention.flash_attention_split.launches != before_split + split_launches):
                fail("flash_attention: the wrapper did not count its launches")
            if (got.shape != ref.shape or lse.shape != (n, p)
                    or not (torch.isfinite(got.float()).all() and torch.isfinite(lse).all())):
                fail(f"flash_attention {dname} {case['what']}: shapes {tuple(got.shape)}, "
                     f"{tuple(lse.shape)} or non-finite output")
            err = (got.float() - ref.float()).abs()
            max_err, max_ref = err.max().item(), ref.float().abs().max().item()
            mean_err, mean_ref = err.mean().item(), ref.float().abs().mean().item()
            lse_err = (lse - ref_lse).abs().max().item()
            lse_ref = ref_lse.abs().max().item()
            # Bars as for the other kernels. lse is f32 in both: the same
            # f32 sums in another order.
            # f32 also at the margin the CPU emulation of the route's
            # arithmetic holds against float64 (tests/test_torch_attention_
            # fwd_f32split.py), so that a build that loses a piece or a
            # product fails here and not only there.
            if dt == torch.float32:
                ok = (max_err <= 1e-4 * max_ref and max_err <= 2.5e-5 * max_ref
                      and lse_err <= 1e-5 * lse_ref)
                rule = "max|err| <= 1e-4 max|ref| and <= 2.5e-5 max|ref|, lse <= 1e-5 max|lse|"
            else:
                ok = max_err <= 3e-2 * max_ref and mean_err <= 2e-3 * mean_ref
                rule = "max|err| <= 3e-2 max|ref|, mean|err| <= 2e-3 mean|ref|"
            ok = ok and lse_err <= 1e-4 * lse_ref
            out, out_lse = torch.empty_like(got), torch.empty_like(lse)
            # the type's peak: bf16 the bound; f32 the CUDA cores' FMA
            peak_ms, bound_by, exp_ms = flash_bound(case, q.element_size(), dname)
            split_bound, own_bound = flash_split_bound(case, dname)
            bound_ms, split_ms, pieces = peak_ms, None, None
            if dt == torch.float32:
                bufs = attention._pieces(q)
                want = (attention.split_pieces_plain(q, 3), attention.split_pieces_plain(k, 3))
                attention._launch_split(q, k, bufs)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(bufs, want)):
                    fail(f"flash_attention_split {case['what']}: pieces differ from "
                         f"split_pieces_plain")
                split_ms = median_ms(torch, lambda: attention._launch_split(q, k, bufs))
                split_plain_ms = median_ms(torch, lambda: (
                    attention.split_pieces_plain(q, 3), attention.split_pieces_plain(k, 3)),
                    n=5, warmup=1)
                kernel_only_ms = median_ms(
                    torch, lambda: attention._launch(*bufs, v, scale, out, out_lse))

                def route():
                    attention._launch_split(q, k, bufs)
                    attention._launch(*bufs, v, scale, out, out_lse)

                kernel_ms = median_ms(torch, route)
                bound_ms, bound_by = own_bound, "operations"
                pieces_bound, pieces_by = flash_pieces_bound(case)
                pieces = dict(max_abs_err=0.0, ms=split_ms, plain_ms=split_plain_ms,
                              bound_ms=pieces_bound, bound_by=pieces_by, library_ms=None)
                del bufs, want
            else:
                kernel_ms = kernel_only_ms = median_ms(
                    torch, lambda: attention._launch(q, k, v, scale, out, out_lse))
            plain_ms = median_ms(torch, lambda: attention.flash_attention_plain(
                q, k, v, scale, block_k=block_k), n=5, warmup=1)
            library_ms, backend = sdpa_library(torch, q, k, v, scale)
            lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
            if dt == torch.float32:
                timing = (f"route {kernel_ms:.4f} ms (split pass {split_ms:.4f} ms, pieces "
                          f"bitwise equal to split_pieces_plain, plain {split_plain_ms:.4f} ms, "
                          f"bound {pieces['bound_ms']:.4f} ms (bytes); kernel "
                          f"{kernel_only_ms:.4f} ms)")
                bounds = (f"bound {bound_ms:.4f} ms (6 bf16 products for q.k^T at the bf16 peak "
                          f"beside p.v on FMA; "
                          f"with the Dv split's recomputed q.k^T {split_bound:.4f} ms; CUDA-core "
                          f"FMA {peak_ms:.4f} ms; exponentials {exp_ms:.4f} ms)")
            else:
                timing = f"kernel {kernel_ms:.4f} ms"
                bounds = (f"bound {bound_ms:.4f} ms ({bound_by}; exponentials {exp_ms:.4f} ms; "
                          f"with the Dv split's recomputed q.k^T {split_bound:.4f} ms)")
            print(f"{card} flash_attention {dname} {case['what']} N={n} P={p} Dk={dk} Dv={dv} "
                  f"scale={scale:.6g}: max|err| {max_err:.6g} (max|ref| {max_ref:.6g}), "
                  f"mean|err| {mean_err:.6g} (mean|ref| {mean_ref:.6g}), lse max|err| "
                  f"{lse_err:.6g} (max|lse| {lse_ref:.6g}) [{rule}; lse <= 1e-4 max|lse|: "
                  f"{'ok' if ok else 'FAIL'}]; {timing}, plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention {lib} ({backend}), {bounds}")
            if not ok:
                fail(f"flash_attention {dname} ({case['what']}) disagrees with its plain version")
            results.setdefault(case["what"], {})[dname] = dict(
                max_abs_err=max_err, lse_max_abs_err=lse_err, ms=kernel_ms,
                kernel_only_ms=kernel_only_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, fma_bound_ms=peak_ms if dt == torch.float32 else None,
                exp_bound_ms=exp_ms, split_bound_ms=split_bound, library_ms=library_ms,
                library_backend=backend, pieces=pieces, shape=[n, p, dk, dv],
                main=bool(case.get("main")))
            del q, k, v, ref, ref_lse, got, lse, err, out, out_lse
        torch.cuda.empty_cache()
    return results


# -------------------------------------------------- flash attention backward
# The train shapes (576x576 crops, output stride 8: c4 72x72, P = 5184, at
# the YAMLs' batch 16), OCNet pyramid level 3 at 1024x2048, and a small
# ragged case. ``main``: the line's.
FLASH_BWD_CASES = [
    dict(what="DANet PAM, train", n=16, p=5184, dk=64, dv=512, scale=1.0, main=True),
    dict(what="OCNet base, train", n=16, p=5184, dk=256, dv=512, scale=256 ** -0.5),
    dict(what="OCNet pyramid level 3", n=9, p=3698, dk=256, dv=512, scale=256 ** -0.5),
    dict(what="ragged", n=2, p=600, dk=32, dv=128, scale=1.0),
]
ATTENTION_BWD_SOURCE = "segmentron_tpu_torch/csrc/attention_bwd.cu"
ATTENTION_BWD_REPLACES = {
    "flash_attention_bwd_dq": "segmentron_tpu/ops/attention.py:161 (_flash_bwd_dq_kernel; "
                              "_attention_pallas_bwd :217, pallas_call :257)",
    "flash_attention_bwd_dkv": "segmentron_tpu/ops/attention.py:185 (_flash_bwd_dkv_kernel; "
                               "_attention_pallas_bwd :217, pallas_call :284)",
}


def flash_bwd_bound(case, itemsize, dname, which):
    """Bounds of one pass: {"ms", "bound_by" ('bytes' | 'operations'),
    "exp_ms"} and, in f32, "fma_ms" beside. The dq pass does q.k^T, do.v^T
    and ds.k, 2 P^2 (2 Dk + Dv) per image; the dk/dv pass q.k^T, do.v^T,
    p^T.do and ds^T.q, 2 P^2 (2 Dk + 2 Dv) (the lo halves of the bf16
    kernels not counted); q, k, v, do, lse and delta read once, the pass's
    outputs written once; the P^2 exponentials of a pass on the
    special-function units, stated beside. In f32 "ms" is the split-TF32
    bound, three TF32 products for each at the TF32 peak (the kernels'
    arithmetic), and "fma_ms" the CUDA cores' at the f32 FMA peak."""
    n, p, dk, dv = case["n"], case["p"], case["dk"], case["dv"]
    out = dk if which == "dq" else dk + dv
    flops = 2 * n * p * p * (2 * dk + (dv if which == "dq" else 2 * dv))
    t_bytes = (n * p * (2 * dk + 2 * dv + out) * itemsize + 2 * n * p * 4) / PEAK_BYTES
    f32 = dname == "float32"
    t_ops = 3 * flops / PEAK_TF32 if f32 else flops / PEAK_OPS[dname]
    bound = dict(ms=1e3 * max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 exp_ms=1e3 * n * p * p / SFU_EXP_PER_S)
    if f32:
        bound["fma_ms"] = 1e3 * max(flops / PEAK_OPS[dname], t_bytes)
    return bound


def sdpa_backward_library(torch, q, k, v, do, scale):
    """(ms, backend) of the backward of ``F.scaled_dot_product_attention``
    on the same inputs (one head): forward + backward under autograd less
    the forward alone, or (None, the reason it refused)."""
    from torch.nn.attention import SDPBackend

    q4, k4, v4 = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    do4 = do[:, None]
    names = {int(getattr(SDPBackend, n)): n for n in dir(SDPBackend) if n.isupper()}
    backend = names.get(int(torch._fused_sdp_choice(q4, k4, v4, scale=scale)), "?")

    def forward():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    def forward_backward():
        torch.autograd.grad(forward(), (q4, k4, v4), do4)

    try:
        forward_backward()
    except RuntimeError as e:
        return None, f"{backend}: refused: {str(e).splitlines()[0][:160]}"
    both = median_ms(torch, forward_backward, n=10, warmup=2)
    with torch.no_grad():
        alone = median_ms(torch, forward, n=10, warmup=2)
    return both - alone, backend


def check_flash_bwd_kernels(torch, attention, card, dev, gen, cases=None, forward=None):
    """Every case in f32 and bf16: ``flash_attention_bwd`` (which launches
    the dq and the dk/dv kernel) against ``flash_attention_bwd_plain`` on
    the same q, k, v, do, out and lse (out and lse from ``forward``, the
    forward kernel unless given); times of each kernel alone, the plain
    backward and the backward of ``scaled_dot_product_attention``.

    Bars, per gradient: f32 max|err| <= 1e-4 max(1, max|ref|) (f32 sums in
    another order); bf16 max|err| <= 2 bf16 ulps of max|ref| and relative
    L2 error <= 4e-3 (both round one f32 result to bf16; the kernel's hi/lo
    products keep ~16 bits of p and ds)."""
    results = {}
    for case in cases or FLASH_BWD_CASES:
        n, p, dk, dv, scale = case["n"], case["p"], case["dk"], case["dv"], case["scale"]
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            q, k = (torch.randn(n, p, dk, generator=gen).to(dev, dt) for _ in range(2))
            v, do = (torch.randn(n, p, dv, generator=gen).to(dev, dt) for _ in range(2))
            out, lse = (forward or attention.flash_attention)(q, k, v, scale)
            refs = attention.flash_attention_bwd_plain(q, k, v, do, out, lse, scale)
            before = (attention.flash_attention_bwd_dq.launches,
                      attention.flash_attention_bwd_dkv.launches)
            got = attention.flash_attention_bwd(q, k, v, do, out, lse, scale)
            torch.cuda.synchronize()
            if (attention.flash_attention_bwd_dq.launches,
                    attention.flash_attention_bwd_dkv.launches) != (before[0] + 1, before[1] + 1):
                fail("flash_attention_bwd: the wrappers did not count their launches")
            errs, ok = {}, True
            for gname, g, r in zip(("dq", "dk", "dv"), got, refs):
                if g.shape != r.shape or g.dtype != dt or not torch.isfinite(g.float()).all():
                    fail(f"flash_attention_bwd {dname} {case['what']}: {gname} of shape "
                         f"{tuple(g.shape)} {g.dtype} or non-finite")
                r = r.float()
                err = (g.float() - r).abs()
                max_err, max_ref = err.max().item(), r.abs().max().item()
                rel_l2 = ((g.float() - r).norm() / r.norm().clamp(min=1e-30)).item()
                if dt == torch.float32:
                    g_ok = max_err <= 1e-4 * max(1.0, max_ref)
                else:
                    ulp = 2.0 ** (math.floor(math.log2(max_ref)) - 7) if max_ref > 0 else 0.0
                    g_ok = max_err <= 2 * ulp and rel_l2 <= 4e-3
                ok = ok and g_ok
                errs[gname] = dict(max_abs_err=max_err, max_ref=max_ref, rel_l2=rel_l2)
            rule = ("max|err| <= 1e-4 max(1, max|ref|)" if dt == torch.float32
                    else "max|err| <= 2 bf16 ulps of max|ref|, rel L2 <= 4e-3")
            lse32, delta = attention._bwd_stats(q, do, out, lse)
            bufs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
            dq_ms = median_ms(torch, lambda: attention._launch_bwd(
                "dq", q, k, v, do, lse32, delta, scale, bufs[0]))
            dkv_ms = median_ms(torch, lambda: attention._launch_bwd(
                "dkv", q, k, v, do, lse32, delta, scale, bufs[1], bufs[2]))
            plain_ms = median_ms(torch, lambda: attention.flash_attention_bwd_plain(
                q, k, v, do, out, lse, scale), n=5, warmup=1)
            library_ms, backend = sdpa_backward_library(torch, q, k, v, do, scale)
            lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"{card} flash_attention_bwd {dname} {case['what']} N={n} P={p} Dk={dk} Dv={dv} "
                  f"scale={scale:.6g}: " + ", ".join(
                      f"{g} max|err| {e['max_abs_err']:.6g} (max|ref| {e['max_ref']:.6g}, rel L2 "
                      f"{e['rel_l2']:.3g})" for g, e in errs.items())
                  + f" [{rule}: {'ok' if ok else 'FAIL'}]; dq kernel {dq_ms:.4f} ms, dk/dv kernel "
                  f"{dkv_ms:.4f} ms, plain backward {plain_ms:.4f} ms, scaled_dot_product_attention "
                  f"backward {lib} ({backend})")
            if not ok:
                fail(f"flash_attention_bwd {dname} ({case['what']}) disagrees with its plain version")
            entry = {}
            for which, ms, gnames in (("dq", dq_ms, ("dq",)), ("dkv", dkv_ms, ("dk", "dv"))):
                bound = flash_bwd_bound(case, q.element_size(), dname, which)
                fma = f", FMA bound {bound['fma_ms']:.4f} ms" if "fma_ms" in bound else ""
                print(f"    {which}: bound {bound['ms']:.4f} ms ({bound['bound_by']}"
                      f"{'; split TF32' if fma else ''}; exponentials {bound['exp_ms']:.4f} ms)"
                      f"{fma}, kernel / bound {ms / bound['ms']:.2f}")
                entry[which] = dict(
                    max_abs_err=max(errs[g]["max_abs_err"] for g in gnames), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound["ms"], bound_by=bound["bound_by"],
                    exp_bound_ms=bound["exp_ms"], library_ms=library_ms, library_backend=backend)
                if fma:
                    entry[which]["fma_bound_ms"] = bound["fma_ms"]
            results.setdefault(case["what"], {})[dname] = dict(
                entry, errors=errs, shape=[n, p, dk, dv], main=bool(case.get("main")))
            del q, k, v, do, out, lse, refs, got, bufs, lse32, delta
        torch.cuda.empty_cache()
    return results


def check_bwd_plans(attention, card):
    """The bf16 kernels' tiles, stages and shared memory as the source picks
    them (``flash_attention_bwd_plan``) against their mirror
    ``ops/attention.py::bwd_plan``, at every case."""
    import ctypes

    for case in FLASH_BWD_CASES:
        for i, which in enumerate(("dq", "dkv")):
            out = (ctypes.c_int * 4)()
            rc = attention._lib_bwd().flash_attention_bwd_plan(i, case["dk"], case["dv"], out)
            src = dict(zip(("rows", "tile", "stages", "smem"), out))
            mirror = attention.bwd_plan(which, case["dk"], case["dv"])
            print(f"{card} flash_attention_bwd bf16 {which} plan {case['what']}: {src}"
                  f"{'' if src == mirror else f' (mirror {mirror})'}")
            if rc != 0 or src != mirror:
                fail(f"bwd_plan({which!r}, {case['dk']}, {case['dv']}) differs from the source's")


def baseline_lib(path, name):
    """The library of another ``csrc/<name>.cu`` at ``path`` (same C
    interface), built with the port's flags beside the port's own; its
    quoted includes are looked up beside it, then in ``csrc/``."""
    import ctypes
    import hashlib

    from segmentron_tpu_torch.ops import kernels

    src = open(path, "rb").read()
    digest = hashlib.sha256(src + kernels._headers(src)).hexdigest()[:16]
    out = kernels.BUILD_DIR / f"lib{name}_baseline-{digest}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-I", str(kernels._SRC),
                           "-o", str(out), path], capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc failed for the baseline {path}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def baseline_bwd_lib(path):
    """The library of another ``attention_bwd.cu`` at ``path``."""
    import ctypes

    lib = baseline_lib(path, "attention_bwd")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_dq_launch.argtypes = [ptr] * 7 + [i, i, i, i, f, i, ptr]
    lib.flash_attention_bwd_dkv_launch.argtypes = [ptr] * 8 + [i, i, i, i, f, i, ptr]
    lib.flash_attention_bwd_dq_launch.restype = i
    lib.flash_attention_bwd_dkv_launch.restype = i
    return lib


def compare_flash_bwd(torch, attention, card, dev, gen, path):
    """At each case in f32 and bf16, the dq and dk/dv kernels of the
    baseline source ``path`` and of this one, each median of 20, in turns
    old, new, new, old; the baseline's results held to this source's (f32:
    1e-4 max(1, max|new|); bf16: 2 bf16 ulps of max|new|, the card's bar).
    Returns {case: {dtype: {"dq"|"dkv": {"old": [ms, ms], "new": [ms, ms]}}}}."""
    old_lib = baseline_bwd_lib(path)
    results = {}
    for case in FLASH_BWD_CASES:
        n, p, dk, dv, scale = case["n"], case["p"], case["dk"], case["dv"], case["scale"]
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            q, k = (torch.randn(n, p, dk, generator=gen).to(dev, dt) for _ in range(2))
            v, do = (torch.randn(n, p, dv, generator=gen).to(dev, dt) for _ in range(2))
            out, lse = attention.flash_attention_plain(q, k, v, scale)
            lse, delta = attention._bwd_stats(q, do, out, lse)
            got = {ver: (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
                   for ver in ("old", "new")}

            def run(ver, which):
                outs = got[ver][:1] if which == "dq" else got[ver][1:]
                if ver == "new":
                    return attention._launch_bwd(which, q, k, v, do, lse, delta, scale, *outs)
                rc = getattr(old_lib, f"flash_attention_bwd_{which}_launch")(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), *(t.data_ptr() for t in outs), n, p, dk, dv,
                    float(scale), int(dt == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
                attention._raise_rc(f"baseline flash_attention_bwd_{which}_launch", rc)

            entry = {}
            for which in ("dq", "dkv"):
                times = {"old": [], "new": []}
                for ver in ("old", "new", "new", "old"):
                    times[ver].append(median_ms(torch, lambda: run(ver, which)))
                entry[which] = times
            torch.cuda.synchronize()
            for gname, a, b in zip(("dq", "dk", "dv"), got["old"], got["new"]):
                err, ref = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
                bar = (1e-4 * max(1.0, ref) if dt == torch.float32
                       else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7) if ref > 0 else 0.0)
                if not err <= bar:
                    fail(f"baseline flash_attention_bwd {dname} {case['what']}: {gname} differs "
                         f"by {err:.6g} (bar {bar:.6g})")
            print(f"{card} flash_attention_bwd {dname} {case['what']}: baseline {path} against "
                  f"this source, old/new/new/old: " + "; ".join(
                      f"{w} old {' '.join(f'{x:.4f}' for x in t['old'])} ms, new "
                      f"{' '.join(f'{x:.4f}' for x in t['new'])} ms" for w, t in entry.items()))
            results.setdefault(case["what"], {})[dname] = entry
            del q, k, v, do, out, lse, delta, got
        torch.cuda.empty_cache()
    return results


def flash_bwd_only(torch, attention, card):
    """``--flash-bwd``: build ``csrc/attention_bwd.cu``, print its ptxas
    report, check both kernels at every case, optionally against a
    baseline source."""
    from segmentron_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build(["attention_bwd"])
    print(f"{card} build attention_bwd: {time.perf_counter() - t0:.2f} s")
    print_ptxas(card, "attention_bwd")
    check_bf16_sass(card)
    check_bwd_plans(attention, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    results = {"flash_attention_bwd": check_flash_bwd_kernels(
        torch, attention, card, dev, gen, forward=attention.flash_attention_plain)}
    for arg in sys.argv[1:]:
        if arg.startswith("--baseline="):
            results["baseline"] = compare_flash_bwd(torch, attention, card, dev, gen,
                                                    arg.split("=", 1)[1])
    print(json.dumps(results))
    return 0


def check_fwd_plans(torch, attention, card):
    """The forward kernels' tiles, ring slots, Dv split and shared memory as
    the source picks them (``flash_attention_plan``) against their mirror
    ``ops/attention.py::fwd_plan``, in bf16 and f32 at every (Dk, Dv) the
    kernels take; each case's plan printed."""
    import ctypes

    keys = ("rows", "tile", "stages", "v_stages", "split", "smem")
    shown = {(c["dk"], c["dv"]) for c in FLASH_CASES}
    for dt in (torch.bfloat16, torch.float32):
        dname = dtype_name(dt)
        for dk in range(16, 257, 16):
            for dv in attention._DV:
                out = (ctypes.c_int * 6)()
                rc = attention._lib().flash_attention_plan(dk, dv, int(dt == torch.bfloat16), out)
                src, mirror = dict(zip(keys, out)), attention.fwd_plan(dk, dv, dt)
                if (dk, dv) in shown or src != mirror:
                    print(f"{card} flash_attention {dname} plan Dk {dk} Dv {dv}: {src}"
                          f"{'' if src == mirror else f' (mirror {mirror})'}")
                if rc != 0 or src != mirror:
                    fail(f"fwd_plan({dk}, {dv}, {dname}) differs from the source's")
    print(f"{card} flash_attention plans: flash_attention_plan equals fwd_plan at all "
          f"{16 * len(attention._DV)} (Dk, Dv) in bf16 and in f32")


def ptxas_spills(name, kernel_re):
    """{function: (spill store bytes, spill load bytes)} of the kernels of
    ``csrc/<name>.cu`` whose mangled name matches ``kernel_re``, from
    ptxas's report of the build."""
    import re

    from segmentron_tpu_torch.ops.kernels import _target

    spills, fn = {}, None
    for ln in _target(name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
            fn = fn if re.search(kernel_re, fn) else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if fn and m:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
    return spills


# HGMMA of a specialisation that may be waited on alone (gsb0): the first
# and the last tile's
F32_FWD_MAX_WAITED = 8


def check_fwd_sass(card):
    """The forward kernels' SASS: each specialisation of the bf16 and the
    f32 kernel must hold HGMMA (wgmma) and UTMALDG (TMA tile loads); the
    f32 kernel (q . k^T on wgmma, p . v on FFMA) no function call, no
    HGMMA waited on alone beyond ``F32_FWD_MAX_WAITED`` and no spill in
    ptxas's report."""
    counts = print_sass_mix(card, "attention", r"flash_(bf16|f32)_kernel", top=10)
    if not counts or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        fail("a flash-forward kernel lacks HGMMA or UTMALDG instructions")
    f32 = {k: c for k, c in counts.items() if k.startswith("flash_f32")}
    if len(f32) != 7:
        fail(f"the f32 flash-forward kernels: {len(f32)} specialisations, want 7")
    # a function call (an IEEE division's or expf's slow path) makes ptxas
    # serialise every wgmma of the kernel
    calls = {k: c["CALL"] for k, c in f32.items() if c["CALL"]}
    if calls:
        fail(f"the f32 flash-forward kernels call functions: {calls}")
    # ptxas serialises every wgmma of a kernel it cannot pipeline: then each
    # HGMMA sets gsb0; a pipelined kernel waits alone only at its ends
    serial = {k: c["HGMMA waited alone"] for k, c in f32.items()
              if c["HGMMA waited alone"] > F32_FWD_MAX_WAITED}
    if serial:
        fail(f"the f32 flash-forward kernels' HGMMA are waited on alone: {serial}")
    spills = ptxas_spills("attention", r"flash_f32_kernel")
    print(f"{card} ptxas attention flash_f32_kernel spills (stores, loads): "
          f"{sorted(set(spills.values()))}; FFMA {[c['FFMA'] for c in f32.values()]}")
    if len(spills) != 7 or any(st or ld for st, ld in spills.values()):
        fail(f"the f32 flash-forward kernel spills: {spills}")


def compare_flash_fwd(torch, attention, card, dev, gen, path):
    """At each case in f32 and bf16, the forward of the baseline source
    ``path`` (another ``attention.cu``, its ``flash_attention_launch`` on
    f32 or bf16 q, k, v) and this one's (in f32 the route: split pass, then
    kernel), each median of 20, in turns old, new, new, old; the baseline's
    out and lse held to this source's at the card's bar of the dtype.
    Returns {case: {dtype: {"old": [ms, ms], "new": [ms, ms]}}}."""
    import ctypes

    old_lib = baseline_lib(path, "attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    old_lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i,
                                               ctypes.c_float, i, ptr]
    old_lib.flash_attention_launch.restype = i
    results = {}
    for case in FLASH_CASES:
        n, p, dk, dv, scale = case["n"], case["p"], case["dk"], case["dv"], case["scale"]
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            q, k = (torch.randn(n, p, dk, generator=gen).to(dev, dt) for _ in range(2))
            v = torch.randn(n, p, dv, generator=gen).to(dev, dt)
            got = {ver: (torch.empty_like(v),
                         torch.empty((n, p), dtype=torch.float32, device=dev))
                   for ver in ("old", "new")}
            bufs = (*attention._pieces(q), v) if dt == torch.float32 else (q, k, v)

            def run(ver):
                out, lse = got[ver]
                if ver == "new":
                    if dt == torch.float32:
                        attention._launch_split(q, k, bufs[:2])
                    return attention._launch(*bufs, scale, out, lse)
                rc = old_lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    n, p, dk, dv, float(scale), int(dt == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
                attention._raise_rc("baseline flash_attention_launch", rc)

            times = {"old": [], "new": []}
            for ver in ("old", "new", "new", "old"):
                times[ver].append(median_ms(torch, lambda: run(ver)))
            torch.cuda.synchronize()
            (a, la), (b, lb) = got["old"], got["new"]
            err = (a.float() - b.float()).abs()
            if dt == torch.float32:
                ok = err.max().item() <= 1e-4 * b.abs().max().item()
            else:
                ok = (err.max().item() <= 3e-2 * b.float().abs().max().item()
                      and err.mean().item() <= 2e-3 * b.float().abs().mean().item())
            ok = ok and (la - lb).abs().max().item() <= 1e-4 * lb.abs().max().item()
            if not ok:
                fail(f"baseline flash_attention {dname} {case['what']}: out or lse differ "
                     f"beyond the bar")
            old_ms, new_ms = statistics.mean(times["old"]), statistics.mean(times["new"])
            print(f"{card} flash_attention {dname} {case['what']} N={n} P={p} Dk={dk} Dv={dv}: "
                  f"baseline {path} against this source, old/new/new/old: old "
                  f"{' '.join(f'{x:.4f}' for x in times['old'])} ms, new "
                  f"{' '.join(f'{x:.4f}' for x in times['new'])} ms; old / new "
                  f"{old_ms / new_ms:.2f}")
            results.setdefault(case["what"], {})[dname] = times
            del q, k, v, got, a, b, la, lb, err, bufs
        torch.cuda.empty_cache()
    return results


def flash_fwd_only(torch, attention, card):
    """``--flash-fwd``: build ``csrc/attention.cu`` alone, print its ptxas
    report, check the forward kernels' SASS and plans, check the forward at
    every case in both dtypes, optionally against a baseline source."""
    from segmentron_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build(["attention"])
    print(f"{card} build attention: {time.perf_counter() - t0:.2f} s")
    print_ptxas(card, "attention")
    check_fwd_sass(card)
    check_fwd_plans(torch, attention, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    results = {"flash_attention": check_flash_kernel(torch, attention, card, dev, gen)}
    for arg in sys.argv[1:]:
        if arg.startswith("--baseline="):
            results["baseline"] = compare_flash_fwd(torch, attention, card, dev, gen,
                                                    arg.split("=", 1)[1])
    print(json.dumps(results))
    return 0


# Probe builds of csrc/attention.cu (--flash-fwd-probe): wrong results, times only.
FLASH_FWD_BUILDS = {
    "full": (),
    "no loads": ("-DATTN_FWD_NO_LOADS",),
    "loads only": ("-DATTN_FWD_LOADS_ONLY",),
    "no softmax": ("-DATTN_FWD_NO_SOFTMAX",),
    "no loads, no softmax": ("-DATTN_FWD_NO_LOADS", "-DATTN_FWD_NO_SOFTMAX"),
}


def flash_fwd_probe(torch, attention, card):
    """``--flash-fwd-probe``: the forward kernels and their probe builds
    (``FLASH_FWD_BUILDS``, built in parallel) at DANet's and OCNet's
    serving and train shapes in f32 (the kernel alone, on pieces from the
    split pass) and bf16, timed in turns (each build, then each again in
    reverse order; median of 20 each); the SASS opcode counts."""
    from segmentron_tpu_torch.ops import kernels

    loaded = probe_libs(card, "attention", FLASH_FWD_BUILDS, attention._lib)
    print_sass_mix(card, "attention", r"flash_(bf16|f32)_kernel")
    dev, gen, results = torch.device("cuda"), torch.Generator().manual_seed(0), {}
    for case in FLASH_CASES[:2] + FLASH_CASES[4:6]:
        n, p, dk, dv, scale = case["n"], case["p"], case["dk"], case["dv"], case["scale"]
        for dt in (torch.float32, torch.bfloat16):
            dname = dtype_name(dt)
            q, k = (torch.randn(n, p, dk, generator=gen).to(dev, dt) for _ in range(2))
            v = torch.randn(n, p, dv, generator=gen).to(dev, dt)
            out, lse = torch.empty_like(v), torch.empty((n, p), dtype=torch.float32, device=dev)
            if dt == torch.float32:
                kernels._loaded["attention"] = loaded["full"]
                bufs = (*attention._pieces(q), v)
                attention._launch_split(q, k, bufs[:2])
            else:
                bufs = (q, k, v)
            times = {}
            for name in [*loaded, *reversed(loaded)]:
                kernels._loaded["attention"] = loaded[name]
                times.setdefault(name, []).append(median_ms(
                    torch, lambda: attention._launch(*bufs, scale, out, lse)))
            torch.cuda.synchronize()
            print(f"{card} flash_attention {dname} {case['what']} probe builds, ms (in turns): "
                  + "; ".join(f"{b} {' '.join(f'{x:.4f}' for x in t)}" for b, t in times.items()))
            results.setdefault(case["what"], {})[dname] = times
            del q, k, v, out, lse, bufs
        torch.cuda.empty_cache()
    kernels._loaded["attention"] = loaded["full"]
    print(json.dumps(results))
    return 0


# Probe builds of csrc/attention_bwd.cu (--flash-bwd-probe); "cvt" gives the
# kernels' results, the others wrong ones (times only).
FLASH_BWD_BUILDS = {
    "full": (),
    "cvt": ("-DATTN_BWD_CVT",),
    "no split": ("-DATTN_BWD_NO_SPLIT",),
    "one pass": ("-DATTN_BWD_ONE_PASS",),
    "one pass, no split": ("-DATTN_BWD_ONE_PASS", "-DATTN_BWD_NO_SPLIT"),
    "no loads": ("-DATTN_BWD_NO_LOADS",),
    "no loads, one pass, no split": ("-DATTN_BWD_NO_LOADS", "-DATTN_BWD_ONE_PASS",
                                     "-DATTN_BWD_NO_SPLIT"),
    "loads only": ("-DATTN_BWD_LOADS_ONLY",),
}
# Probe builds of the bf16 kernels: wrong results, times only.
FLASH_BWD_BF16_BUILDS = {
    "full": (),
    "no loads": ("-DATTN_BWD_NO_LOADS",),
    "loads only": ("-DATTN_BWD_LOADS_ONLY",),
    "no s, dp products": ("-DATTN_BWD_NO_SDP",),
    "no p, ds products": ("-DATTN_BWD_NO_GRAD",),
    "no exchange": ("-DATTN_BWD_NO_EXCHANGE",),
    "no loads, no products": ("-DATTN_BWD_NO_LOADS", "-DATTN_BWD_NO_SDP",
                              "-DATTN_BWD_NO_GRAD"),
}
# (threads a block, independent accumulators a warp) of the mma.sync peak
MMA_PEAK_SHAPES = [(256, 8), (512, 8), (1024, 8), (256, 1), (1024, 1)]
# (threads a block, mode) of the wgmma peak; mode -> (N, how)
WGMMA_PEAK_SHAPES = [(128, 0), (256, 0), (384, 0), (256, 1), (384, 1), (256, 2), (256, 3),
                     (256, 4)]
WGMMA_PEAK_MODES = {0: (256, "A, B K-major from shared memory"), 1: (256, "A from registers"),
                    2: (256, "A from registers, B MN-major"),
                    3: (32, "A, B K-major from shared memory"),
                    4: (64, "A from registers, B MN-major")}


def print_sass_mix(card, name, kernels_re, top=14):
    """The most frequent SASS opcodes (as cuobjdump prints them) of each
    kernel of ``csrc/<name>.cu`` whose mangled name matches ``kernels_re``:
    a static count over the kernel's code, not a dynamic one."""
    import collections
    import re
    import shutil

    from segmentron_tpu_torch.ops.kernels import _target

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print(f"{card} sass {name}: cuobjdump not found")
        return
    sass = subprocess.run([tool, "-sass", str(_target(name))], capture_output=True,
                          text=True, check=True).stdout
    # gzipped: the listings of every source together pass the 64 MiB that a
    # chip run brings back
    with gzip.open(os.path.join(OUT_DIR, f"{name}.sass.gz"), "wt") as f:
        f.write(sass)
    counts = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        if not re.search(kernels_re, fn):
            continue
        ops = collections.Counter(m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T] )?([A-Z][A-Z0-9_]*)", part))
        short = re.search(r"((?:dq|dkv|flash)_(?:f32|bf16)_kernel)(?:ILi(\d+)ELi(\d+)E)?", fn)
        sep = re.search(r"(sepconv_wgmma_kernel)ILi(\d)ELi(\d+)ELi(\d)ELi(\d)E", fn)
        ent = re.search(r"stem(?:_block1)?_wgmma_kernel", fn)
        label = (ent.group(0) if ent else
                 f"{sep.group(1)}<{'s8' if sep.group(2) == '1' else 'bf16'}, N {sep.group(3)}, "
                 f"d {sep.group(4)}, {('no skip', 'conv skip', 'sum skip')[int(sep.group(5))]}>"
                 if sep else f"{short.group(1)}<{short.group(2)}, {short.group(3)}>"
                 if short and short.group(2) else short.group(1) if short else fn[:60])
        counts[label] = ops
        # an HGMMA (IGMMA: s8) that sets gsb0 is waited on before the next issues
        waited = len(re.findall(r"[HI]GMMA[^;]*gsb0", part))
        print(f"{card} sass {name} {label}: {sum(ops.values())} instructions: "
              + ", ".join(f"{op} {c}" for op, c in ops.most_common(top))
              + f"; HGMMA {ops['HGMMA']}, IGMMA {ops['IGMMA']} ({waited} with gsb0), "
              f"UTMALDG {ops['UTMALDG']}, UTMASTG {ops['UTMASTG']}")
        ops["HGMMA waited alone"] = waited
    return counts


def check_bf16_sass(card):
    """The bf16 backward kernels' SASS: each must hold HGMMA (wgmma) and
    UTMALDG (TMA tile loads)."""
    counts = print_sass_mix(card, "attention_bwd", r"(dq|dkv)_bf16_kernel", top=10)
    if not counts or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        fail("the bf16 flash-backward kernels lack HGMMA or UTMALDG instructions")


def time_probe_builds(torch, attention, card, libs, dt, gen):
    """Each build in ``libs`` (name -> loaded library) at DANet's and
    OCNet's train shapes in dtype ``dt``, in turns (each build, then each
    again in reverse order; median of 20 each). Returns {case: {"dq" |
    "dkv": {build: [ms, ms]}}}; "cvt", where present, held bitwise to
    "full"."""
    from segmentron_tpu_torch.ops import kernels

    dev, dname, results = torch.device("cuda"), dtype_name(dt), {}
    for case in FLASH_BWD_CASES[:2]:
        n, p, dk, dv, scale = case["n"], case["p"], case["dk"], case["dv"], case["scale"]
        q, k = (torch.randn(n, p, dk, generator=gen).to(dev, dt) for _ in range(2))
        v, do = (torch.randn(n, p, dv, generator=gen).to(dev, dt) for _ in range(2))
        out, lse = attention.flash_attention_plain(q, k, v, scale)
        lse, delta = attention._bwd_stats(q, do, out, lse)
        got = {b: (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)) for b in libs}
        times = {}
        for b in [*libs, *reversed(libs)]:
            kernels._loaded["attention_bwd"] = libs[b]
            for which, outs in (("dq", got[b][:1]), ("dkv", got[b][1:])):
                times.setdefault(which, {}).setdefault(b, []).append(median_ms(
                    torch, lambda: attention._launch_bwd(which, q, k, v, do, lse, delta, scale,
                                                         *outs)))
        torch.cuda.synchronize()
        same = ("; full bitwise equal to cvt: "
                + str(all(torch.equal(a, c) for a, c in zip(got["full"], got["cvt"])))
                if "cvt" in got else "")
        print(f"{card} flash_attention_bwd {dname} {case['what']} probe builds, ms (in turns): "
              + "; ".join(f"{which} " + ", ".join(
                  f"{b} {' '.join(f'{x:.4f}' for x in t)}" for b, t in per.items())
                  for which, per in times.items()) + same)
        results[case["what"]] = times
        del q, k, v, do, out, lse, delta, got
        torch.cuda.empty_cache()
    return results


def load_probe_builds(attention, builds):
    """{name: the library of csrc/attention_bwd.cu built with flags}."""
    from segmentron_tpu_torch.ops import kernels

    libs = {}
    for name, flags in builds.items():
        kernels.DEFINES["attention_bwd"] = flags
        kernels._loaded.pop("attention_bwd", None)
        libs[name] = attention._lib_bwd()
    return libs


def flash_bwd_probe(torch, attention, card, dtypes=("float32", "bfloat16")):
    """``--flash-bwd-probe[=f32|bf16]``: the kernels of each dtype and their
    probe builds (``FLASH_BWD_BUILDS``, ``FLASH_BWD_BF16_BUILDS``) at the
    train shapes, timed in turns; the SASS opcode counts of the kernels;
    the issue rates of ``mma.sync`` m16n8k8 tf32 (``MMA_PEAK_SHAPES``, 4
    blocks an SM) and of ``wgmma`` m64nNk16 bf16 (``WGMMA_PEAK_SHAPES``,
    one block an SM)."""
    from segmentron_tpu_torch.ops import kernels

    import ctypes

    gen = torch.Generator().manual_seed(0)
    results = {}
    for dname, builds, sass_re in (
            ("float32", FLASH_BWD_BUILDS, r"(dq|dkv)_f32_kernelILi512E"),
            ("bfloat16", FLASH_BWD_BF16_BUILDS, r"(dq|dkv)_bf16")):
        if dname not in dtypes:
            continue
        libs = load_probe_builds(attention, builds)
        kernels.DEFINES["attention_bwd"] = builds["full"]
        print_sass_mix(card, "attention_bwd", sass_re)
        results[dname] = time_probe_builds(torch, attention, card, libs,
                                           getattr(torch, dname), gen)
    dev = torch.device("cuda")
    kernels.DEFINES["attention_bwd"] = ("-DATTN_BWD_MMA_PEAK",)
    kernels._loaded.pop("attention_bwd", None)
    lib = attention._lib_bwd()
    sink, iters = torch.zeros(1024, device=dev), 4096
    peak = lib.attention_bwd_mma_peak
    peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    wpeak = lib.attention_bwd_wgmma_peak
    wpeak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    rates = {}
    for what, fn, shapes, blocks in (("mma.sync m16n8k8 tf32", peak, MMA_PEAK_SHAPES, 132 * 4),
                                     ("wgmma bf16", wpeak, WGMMA_PEAK_SHAPES, 132)):
        for threads, arg in shapes:
            def run():
                attention._raise_rc(what, fn(sink.data_ptr(), blocks, threads, iters, arg,
                                             torch.cuda.current_stream().cuda_stream))
            ms = median_ms(torch, run, n=10)
            if what.startswith("wgmma"):
                n, how = WGMMA_PEAK_MODES[arg]
                flops = 2.0 * 64 * n * 64 * blocks * (threads // 128) * iters
                how = f"m64n{n}k16, {how}"
            else:
                flops = 2.0 * 16 * 8 * 8 * blocks * (threads // 32) * iters * arg
                how = f"{arg} accumulator chain(s) a warp"
            rate = flops / ms / 1e9
            rates[f"{what}, {threads} threads, {how}"] = rate
            print(f"{card} {what}: {blocks} blocks of {threads} threads, {how}: {ms:.4f} ms, "
                  f"{rate:.1f} TFLOP/s")
    results["rates_tflops"] = rates
    print(json.dumps(results))
    kernels.DEFINES.pop("attention_bwd", None)
    kernels._loaded.pop("attention_bwd", None)
    return 0


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
                fused_stem=0, flash_attention=0, flash_attention_split=0,
                # no model runs probe_dot
                flash_attention_bwd_dq=0, flash_attention_bwd_dkv=0, probe_dot=0)
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


def reset_cfg(cfg, defaults):
    """``cfg`` as a fresh process has it."""
    cfg.defrost()
    cfg.clear()
    for key, value in type(cfg)(defaults).items():
        dict.__setitem__(cfg, key, value)


def load_cfg(cfg, defaults, yaml, opts):
    """``cfg`` as a fresh process has it, then ``yaml`` and ``opts``."""
    reset_cfg(cfg, defaults)
    cfg.update_from_file(yaml)
    cfg.update_from_list(opts)


def set_attention(model, use_pallas):
    """Route every spatial attention of ``model`` through the flash kernel
    (True) or the dense function (False)."""
    for m in model.modules():
        if hasattr(m, "use_pallas"):
            m.use_pallas = use_pallas


def attention_models(torch, card, dev, defaults, counts, profile_forward, profile_call):
    """Phase 6: DANet and OCNet over ResNet-101 at output stride 8 from
    their serving configs, full width, random weights from the seed, BN
    statistics drawn as for the flagship and ``gamma = GAMMA``.

    In f32 (TF32 off) the kernel route's argmax is held to the dense
    route's (>= 0.995), for DANet, OCNet base and OCNet pyramid (one launch
    of the split pass and of the kernel a flash attention); for DANet and
    OCNet base the f32 kernel-route forward is timed (median of 3) and
    profiled once, for the flash forward's share of it; then,
    with the launch counters set to 0 just before and read just after,
    each of DANet and OCNet base runs through the ``Evaluator`` in bf16
    over synthetic 1024x2048 images (one kernel launch a forward); the
    bf16 kernel route's argmax is held to the f32 reference no worse than
    the dense bf16 route's, less 0.005; both routes' forwards are timed in
    turns and one kernel-route forward is profiled. OCNet pyramid runs one
    bf16 forward (three launches: levels 1, 2 and 3; level 6 is dense).

    ``defaults``: the cfg's default tree; ``counts``: (zero the launch
    counters, read them); ``profile_forward``, ``profile_call``: profilers
    of a forward and of a call."""
    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import Evaluator, make_predict_fn

    zero_counts, read_counts = counts

    def agreement(a, b):
        return (a == b).float().mean().item()

    def build(name, arch="base"):
        load_cfg(cfg, defaults, ATTENTION_MODELS[name],
                 ATTENTION_OPTS + ["MODEL.OCNet.OC_ARCH", arch])
        return attention_model(torch, dev, cfg)

    data = SyntheticSegmentation(split="val", mode="testval", length=2, image_size=SHAPE[1:3])
    image = torch.from_numpy(data[0][0][None]).to(dev)
    per_forward = {"DANet": 1, "OCNet": 1, "OCNet pyramid": 3}
    results = {}
    for label in ("DANet", "OCNet", "OCNet pyramid"):
        name, arch = (label, "base") if label != "OCNet pyramid" else ("OCNet", "pyramid")
        torch.backends.cudnn.allow_tf32 = False
        model, n_gamma = build(name, arch)
        predict32 = make_predict_fn(model, "float32", dev)
        with torch.inference_mode():
            set_attention(model, False)
            ref = predict32(image).argmax(-1)
            set_attention(model, True)
            zero_counts()
            kernel32 = predict32(image).argmax(-1)
            counts32 = read_counts()
        launches32 = counts32["flash_attention"]
        split32 = counts32["flash_attention_split"]
        agree32 = agreement(kernel32, ref)
        print(f"{card} {label} / resnet101, output stride 8, {model.nclass} classes, "
              f"{sum(p.numel() for p in model.parameters())} parameters, gamma {GAMMA} "
              f"({n_gamma}); f32 {SHAPE}: kernel route launches {launches32} (split pass "
              f"{split32}), argmax agreement with the dense route {agree32:.6f} [>= 0.995]")
        if launches32 != per_forward[label] or split32 != per_forward[label]:
            fail(f"{label}: {launches32} flash launches and {split32} of the split pass in an "
                 f"f32 forward, want {per_forward[label]} each")
        if agree32 < 0.995:
            fail(f"{label}: the kernel route's f32 argmax agrees with the dense route's on "
                 f"less than 0.995 of the pixels")
        f32_share = None
        if label != "OCNet pyramid":
            def forward32():
                with torch.inference_mode():
                    return predict32(image)

            fwd32_ms = median_ms(torch, forward32, n=3, warmup=1)
            prof32 = profile_call(forward32,
                                  f"one f32 forward, {label} kernel route, 1x{SHAPE[1]}x{SHAPE[2]}",
                                  f"chip_smoke_profile_{name.lower()}_f32.txt",
                                  match=r"flash_f32_kernel|split_planes_kernel")
            f32_share = dict(forward_ms=fwd32_ms, flash_ms=prof32["matched_ms"],
                             kernels_ms=prof32["kernels_ms"],
                             share_of_kernels=prof32["matched_ms"] / prof32["kernels_ms"],
                             share_of_forward=prof32["matched_ms"] / fwd32_ms)
            print(f"{card} {label} f32 forward, kernel route: {fwd32_ms:.3f} ms (median of 3); "
                  f"the flash forward (split pass and kernel) {prof32['matched_ms']:.3f} ms of "
                  f"{prof32['kernels_ms']:.3f} ms of kernels in one profiled forward, "
                  f"{f32_share['share_of_kernels']:.4f} of the kernel time, "
                  f"{f32_share['share_of_forward']:.4f} of the forward")
        torch.backends.cudnn.allow_tf32 = True  # the model's own default from here on
        if label == "OCNet pyramid":
            predict = make_predict_fn(model, cfg.TPU.COMPUTE_DTYPE, dev)
            with torch.inference_mode():
                zero_counts()
                half = predict(image).argmax(-1)
                launches = read_counts()["flash_attention"]
            agree16 = agreement(half, ref)
            print(f"{card} {label} bf16: launches {launches} in one forward, argmax agreement "
                  f"with the f32 reference {agree16:.6f}")
            if launches != per_forward[label]:
                fail(f"{label}: {launches} flash launches in a bf16 forward, want 3")
            results[label] = dict(launches_per_forward=launches, argmax_agreement_f32=agree32,
                                  argmax_agreement_bf16_vs_f32=agree16)
            continue

        # the main path: the Evaluator, counters read around it
        evaluator = Evaluator(model, data)  # casts the weights to bf16
        zero_counts()
        t0 = time.perf_counter()
        pix_acc, miou, _ = evaluator.eval()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        print(f"{card} eval, {label}: {len(data)} images {SHAPE[1]}x{SHAPE[2]} "
              f"{cfg.TPU.COMPUTE_DTYPE} in {seconds:.3f} s: pixAcc {pix_acc:.6f}, mIoU "
              f"{miou:.6f}; launches {launches}")
        if launches["flash_attention"] != per_forward[label] * len(data):
            fail(f"{label}: flash_attention was not launched once per image")
        if any(v for k, v in launches.items() if k != "flash_attention"):
            fail(f"{label}: kernels of other paths launched")
        predict = evaluator.predict_fn
        with torch.inference_mode():
            logits = predict(image)
            if logits.shape != (1, SHAPE[1], SHAPE[2], model.nclass):
                fail(f"{label}: logits shape {tuple(logits.shape)}")
            if not torch.isfinite(logits).all():
                fail(f"{label}: non-finite logits")
            half = {}
            for route in (True, False):
                set_attention(model, route)
                half[route] = predict(image).argmax(-1)
            # kernel and dense routes in turns, 2 rounds of 8
            fwd = {True: [], False: []}
            for rnd in range(2):
                for route in ((True, False) if rnd == 0 else (False, True)):
                    set_attention(model, route)
                    fwd[route].append(median_ms(torch, lambda: predict(image), n=8, warmup=2))
            set_attention(model, True)
        agree16 = {route: agreement(half[route], ref) for route in (True, False)}
        ms = {route: statistics.median(v) for route, v in fwd.items()}
        print(f"{card} {label} bf16 forward (1, {SHAPE[1]}, {SHAPE[2]}, 3) uint8 -> f32 logits, "
              f"ms (img/s), medians of rounds in turns: kernel route {ms[True]:.3f} "
              f"({1e3 / ms[True]:.2f}) {[round(v, 3) for v in fwd[True]]}, dense route "
              f"{ms[False]:.3f} ({1e3 / ms[False]:.2f}) {[round(v, 3) for v in fwd[False]]}; "
              f"argmax agreement with the f32 reference: kernel {agree16[True]:.6f}, dense "
              f"{agree16[False]:.6f} [kernel >= dense - 0.005]")
        if agree16[True] < agree16[False] - 0.005:
            fail(f"{label}: the kernel route's bf16 argmax is further from the f32 reference "
                 f"than the dense route's by more than 0.005")
        profile = profile_forward(predict, f"{label} kernel route", image,
                                  f"chip_smoke_profile_{name.lower()}.txt")
        results[label] = dict(
            images=len(data), eval_seconds=seconds, pix_acc=pix_acc, miou=miou,
            launches=launches["flash_attention"], forward_ms=ms[True],
            img_per_s=1e3 / ms[True], dense_forward_ms=ms[False],
            rounds={"kernel": fwd[True], "dense": fwd[False]},
            argmax_agreement_f32=agree32, f32_launches=counts32, f32_forward=f32_share,
            argmax_agreement_bf16_vs_f32={"kernel": agree16[True], "dense": agree16[False]},
            profile=profile)
        del evaluator, predict, model
        torch.cuda.empty_cache()
    return results


# The COCO-Stuff training configs (ResNet-101, output stride 8, multi-grid
# for DANet, 21 classes, 576x576 crops, batch 16, bf16, SGD at LR 0.003, poly).
TRAIN_MODELS = {
    "DANet": "configs/cocostuff_danet_resnet101.yaml",
    "OCNet": "configs/cocostuff_ocnet_resnet101.yaml",
}
TRAIN_ITERS_PER_EPOCH = 100  # sets only the poly schedule's length
TRAIN_CHECK_BATCH = 2


def grad_rel_l2(got, want, floor):
    """{leaf: ||got - want|| / max(||want||, floor)}."""
    return {n: ((got[n] - w).norm() / max(w.norm().item(), floor)).item()
            for n, w in want.items()}


def f64_dense_grads(torch, state, images, masks, loss_fn, seed):
    """Gradients of one dense-route train step of a float64 twin of
    ``model`` (built anew from the cfg) at the weights ``state``: the same
    batch and dropout draws, BN with the batch statistics, and the
    attention and CAM products in float64 (the port's modules take those
    in f32)."""
    import torch.nn.functional as F

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.models import danet, get_segmentation_model
    from segmentron_tpu_torch.ops import attention

    def dense64(q, k, v, scale):
        return torch.bmm(torch.softmax(torch.bmm(q, k.transpose(1, 2)) * scale, dim=-1), v)

    def cam64(self, x):
        h, w = x.shape[2:]
        flat = danet.flatten(x)
        energy = torch.bmm(flat.transpose(1, 2), flat)
        attn = torch.softmax(energy.amax(dim=-1, keepdim=True) - energy, dim=-1)
        return self.gamma * danet.unflatten(torch.bmm(flat, attn.transpose(1, 2)), h, w) + x

    m64 = get_segmentation_model(images.device)
    m64.load_state_dict(state)
    m64.double().train()
    set_attention(m64, False)
    for m in m64.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.forward = (lambda x, m=m: F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0,
                                                     m.eps))
        if hasattr(m, "generator"):
            m.generator = torch.Generator(device=images.device).manual_seed(seed)
    real = attention._attention_dense, danet.CAM.forward
    attention._attention_dense, danet.CAM.forward = dense64, cam64
    try:
        mean, std = (torch.tensor(v, device=images.device, dtype=torch.float64)
                     for v in (cfg.DATASET.MEAN, cfg.DATASET.STD))
        loss_fn(m64((images.double() / 255 - mean) / std), masks.long()).backward()
    finally:
        attention._attention_dense, danet.CAM.forward = real
    grads = {n: p.grad.float() for n, p in m64.named_parameters()}
    del m64
    torch.cuda.empty_cache()
    return grads


def train_models(torch, card, dev, defaults, counts, profile_call):
    """Phase 7: one train step of DANet and OCNet base from the COCO-Stuff
    YAMLs at full width through ``get_segmentation_loss`` /
    ``get_lr_scheduler`` / ``get_optimizer`` / ``make_train_step``, random
    weights from the seed, ``gamma = GAMMA``, synthetic 576x576 crops.

    In f32 (TF32 off) at batch 2, from the same weights, batch and
    dropout generator state: the flash route (forward kernel, dq and dk/dv
    kernels) against the dense route, loss to relative 1e-5, every
    gradient leaf to relative L2 max(1e-4, a quarter of the dense step's
    own distance from a float64 step): the train-mode BN of a random
    ResNet-101 amplifies f32 rounding so far that both f32 steps are
    several per cent from float64, and the two routes' different
    summation orders alone then differ by more than 1e-4. Every
    parameter after the update within that fraction of its update plus
    one f32 ulp of the parameter; PAM's and the OC block's query/key/value
    gradients nonzero. In bf16 at the
    same batch, each route's gradients against the f32 dense step's: the
    kernel route no further than the dense route x 1.5 + 1e-3 (per leaf,
    the leaves whose f32 gradient is 0 up to rounding left out).
    Then the main path in bf16 at the YAML's batch (8 if 16 does not fit):
    the launch counters set to 0 just before one step and read just after
    (flash forward, dq and dk/dv once each), 2 warm-up steps and 10 steps
    of each route in turns (CUDA events), peak memory, 5 more steps with
    ``torch.backends.cudnn.benchmark`` on, one profiled step.

    A gradient leaf's relative L2 is taken against max(its norm, 1e-6 of
    the norm of all gradients), and leaves below that are not gated: some
    gradients are 0 up to rounding (PAM's key bias adds q . b to a whole
    softmax row; a bias before a training-mode BN is removed by it)."""
    import numpy as np

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import make_train_step
    from segmentron_tpu_torch.models import get_segmentation_model
    from segmentron_tpu_torch.solver import (get_lr_scheduler, get_optimizer,
                                             get_segmentation_loss)

    zero_counts, read_counts = counts
    qkv = {"DANet": ("pam.query.", "pam.key.", "pam.value."),
           "OCNet": ("oc.attn.f_query.", "oc.attn.f_key.", "oc.attn.f_value.")}
    results = {}
    for label, yaml in TRAIN_MODELS.items():
        load_cfg(cfg, defaults, yaml, [])
        crop, batch = int(cfg.TRAIN.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
        gen = torch.Generator().manual_seed(int(cfg.SEED))
        model = get_segmentation_model(dev, generator=gen)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("gamma"):
                    p.fill_(GAMMA)
        state0 = {k: v.clone() for k, v in model.state_dict().items()}
        data = SyntheticSegmentation(split="train", mode="testval", length=batch,
                                     image_size=(crop, crop), num_class=model.nclass)
        pairs = [data[i][:2] for i in range(batch)]
        images = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
        masks = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
        loss_fn = get_segmentation_loss(
            cfg.MODEL.MODEL_NAME, use_ohem=cfg.SOLVER.OHEM, aux=cfg.SOLVER.AUX,
            aux_weight=cfg.SOLVER.AUX_WEIGHT, loss_name=cfg.SOLVER.LOSS_NAME,
            ohem_thresh=cfg.SOLVER.OHEM_THRESH, ohem_min_kept=cfg.SOLVER.OHEM_MIN_KEPT,
            multi_loss_weight=list(cfg.MODEL.MULTI_LOSS_WEIGHT))

        def make_step(route, dtype):
            """A fresh optimizer and train step from the weights of state0."""
            model.load_state_dict(state0)
            set_attention(model, route)
            schedule = get_lr_scheduler(cfg, TRAIN_ITERS_PER_EPOCH)
            optimizer = get_optimizer(cfg, model, schedule)
            generator = torch.Generator(device=dev).manual_seed(int(cfg.SEED))
            return make_train_step(model, loss_fn, optimizer, schedule, compute_dtype=dtype,
                                   device=dev, generator=generator)

        def one_step(route, dtype, n):
            step = make_step(route, dtype)
            loss = step(images[:n], masks[:n]).item()
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
            update = {k: (p.detach() - state0[k]) for k, p in model.named_parameters()}
            return loss, grads, update

        # ---- f32: the flash route against the dense route
        torch.backends.cudnn.allow_tf32 = False
        n2 = TRAIN_CHECK_BATCH
        zero_counts()
        loss_k, grads_k, upd_k = one_step(True, "float32", n2)
        launches32 = read_counts()
        loss_d, grads_d, upd_d = one_step(False, "float32", n2)
        floor = 1e-6 * torch.sqrt(sum(g.square().sum() for g in grads_d.values())).item()
        gated = [n for n, g in grads_d.items() if g.norm().item() >= floor]
        rel_g = grad_rel_l2(grads_k, grads_d, floor)
        # how far the f32 dense step itself is from float64, per leaf
        rel_64 = grad_rel_l2(grads_d, f64_dense_grads(torch, state0, images[:n2],
                                                      masks[:n2], loss_fn, int(cfg.SEED)), floor)
        tol = {n: max(1e-4, 0.25 * rel_64[n]) for n in grads_d}
        over_g = {n: (rel_g[n], tol[n]) for n in gated if rel_g[n] > tol[n]}
        # params after the update: within tol of the update, one f32 ulp of
        # the parameter (p - lr g rounds to either neighbour) and, for the
        # leaves whose gradient is 0 up to rounding, 1e-6 of LR x the largest
        # gradient
        lr_max = float(cfg.SOLVER.LR) * float(cfg.SOLVER.DECODER_LR_FACTOR)
        g_max = max(g.abs().max().item() for g in grads_d.values())
        rel_u = {n: (upd_k[n] - u).abs().max().item() / (
                     tol[n] * u.abs().max().item() + 2.0 ** -22 * state0[n].abs().max().item()
                     + 1e-6 * lr_max * g_max) for n, u in upd_d.items()}
        worst_g = max(gated, key=lambda n: rel_g[n] / tol[n])
        worst_u = max(rel_u, key=rel_u.get)
        qkv_norms = {n: g.norm().item() for n, g in grads_k.items()
                     if n.startswith(qkv[label]) and g.dim() == 4}  # the conv weights
        loss_rel = abs(loss_k - loss_d) / abs(loss_d)
        print(f"{card} train {label} / resnet101, output stride 8, {model.nclass} classes, crop "
              f"{crop}, f32 step at batch {n2}: loss kernel route {loss_k:.7f}, dense "
              f"{loss_d:.7f} (rel {loss_rel:.3g}) [<= 1e-5]; gradient leaves {len(gated)} of "
              f"{len(rel_g)} (the others 0 up to rounding), kernel vs dense rel L2 median "
              f"{statistics.median(rel_g[n] for n in gated):.3g}, worst against its bar "
              f"{rel_g[worst_g]:.3g} ({worst_g}; bar {tol[worst_g]:.3g}) [<= max(1e-4, 0.25 x the "
              f"dense step's own distance from float64, median "
              f"{statistics.median(rel_64[n] for n in gated):.3g}): {len(over_g)} over]; "
              f"parameters after the update, worst max|diff| / bar {rel_u[worst_u]:.3g} "
              f"({worst_u}) [<= 1]; q/k/v weight grad norms "
              f"{ {n: round(v, 6) for n, v in qkv_norms.items()} } [> 0]; launches {launches32}")
        if not (math.isfinite(loss_k) and loss_rel <= 1e-5):
            fail(f"train {label}: f32 loss of the kernel route differs from the dense route's")
        if over_g or rel_u[worst_u] > 1:
            fail(f"train {label}: f32 gradients or updates of the kernel route differ from the "
                 f"dense route's: {dict(list(over_g.items())[:5])}")
        if len(qkv_norms) != 3 or min(qkv_norms.values()) <= 0:
            fail(f"train {label}: the attention's query/key/value convs got no gradient")
        if (launches32["flash_attention"], launches32["flash_attention_split"],
                launches32["flash_attention_bwd_dq"],
                launches32["flash_attention_bwd_dkv"]) != (1, 1, 1, 1):
            fail(f"train {label}: f32 step launches {launches32}")
        torch.backends.cudnn.allow_tf32 = True  # the model's own default from here on

        # ---- bf16 at the same batch: each route against the f32 dense step
        half_rel = {}
        for route in (True, False):
            _, grads_h, _ = one_step(route, cfg.TPU.COMPUTE_DTYPE, n2)
            half_rel[route] = grad_rel_l2(grads_h, grads_d, floor)
            del grads_h
        # leaves whose f32 gradient is 0 up to rounding have nothing for bf16
        # to approximate: left out of this gate
        worse = {n: (half_rel[True][n], half_rel[False][n]) for n in gated
                 if half_rel[True][n] > 1.5 * half_rel[False][n] + 1e-3}
        worst_h = max(gated, key=half_rel[True].get)
        print(f"{card} train {label} {cfg.TPU.COMPUTE_DTYPE} step at batch {n2}: gradients vs the "
              f"f32 dense step, worst leaf rel L2 kernel route {half_rel[True][worst_h]:.4g} "
              f"({worst_h}; dense route {half_rel[False][worst_h]:.4g}), median kernel "
              f"{statistics.median(half_rel[True].values()):.4g} dense "
              f"{statistics.median(half_rel[False].values()):.4g} [kernel <= 1.5 dense + 1e-3 per "
              f"leaf, {len(gated)} of {len(grads_d)} leaves: {len(worse)} over]")
        if worse:
            fail(f"train {label}: bf16 kernel route's gradients further from f32 than the dense "
                 f"route's: {dict(list(worse.items())[:5])}")
        del grads_k, grads_d, upd_k, upd_d

        # ---- the main path: bf16 at the YAML's batch
        steps = {}
        cut = None
        for n in (batch, batch // 2):
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                steps[True] = make_step(True, cfg.TPU.COMPUTE_DTYPE)
                zero_counts()
                loss = steps[True](images[:n], masks[:n]).item()
                launches = read_counts()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                break
            except torch.cuda.OutOfMemoryError:
                cut = f"batch {n} did not fit the card; cut to {n // 2}"
                print(f"{card} train {label}: {cut}")
                steps.clear()
        else:
            fail(f"train {label}: batch {batch // 2} does not fit the card either")
        want = dict(flash_attention=1, flash_attention_bwd_dq=1, flash_attention_bwd_dkv=1)
        print(f"{card} train {label} {cfg.TPU.COMPUTE_DTYPE} step at batch {n}: loss {loss:.6f}, "
              f"launches {launches}, peak memory {peak / 2**30:.3f} GiB")
        if {k: launches[k] for k in want} != want or any(
                v for k, v in launches.items() if k not in want):
            fail(f"train {label}: launches in one step {launches}, want {want}")
        if not math.isfinite(loss):
            fail(f"train {label}: non-finite loss")
        # dense route: same weights, its own optimizer; then turns
        step_ms = {True: [], False: []}
        peak_route = {True: peak, False: 0}
        losses = {True: [], False: []}
        for route in (True, False):
            if route is False:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                steps[False] = make_step(False, cfg.TPU.COMPUTE_DTYPE)
            set_attention(model, route)
            for _ in range(2):  # warm-up
                losses[route].append(steps[route](images[:n], masks[:n]).item())
            torch.cuda.synchronize()
            if route is False:
                peak_route[False] = torch.cuda.max_memory_allocated()
        for rnd in range(2):
            for route in ((True, False) if rnd == 0 else (False, True)):
                set_attention(model, route)
                for _ in range(5):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = steps[route](images[:n], masks[:n])
                    end.record()
                    end.synchronize()
                    step_ms[route].append(start.elapsed_time(end))
                    losses[route].append(out.item())
        if not all(math.isfinite(v) for vs in losses.values() for v in vs):
            fail(f"train {label}: non-finite loss in the timed steps")
        ms = {route: statistics.median(v) for route, v in step_ms.items()}
        print(f"{card} train {label} {cfg.TPU.COMPUTE_DTYPE} step, batch {n} of {crop}x{crop}, "
              f"ms (img/s), median of 10 in turns: kernel route {ms[True]:.3f} "
              f"({1e3 * n / ms[True]:.2f}) {[round(v, 3) for v in step_ms[True]]}, dense route "
              f"{ms[False]:.3f} ({1e3 * n / ms[False]:.2f}) {[round(v, 3) for v in step_ms[False]]}; "
              f"peak memory kernel {peak_route[True] / 2**30:.3f} GiB, dense "
              f"{peak_route[False] / 2**30:.3f} GiB; losses kernel "
              f"{[round(v, 4) for v in losses[True]]}")
        set_attention(model, True)
        # the same step with cuDNN's algorithms timed instead of picked by
        # its heuristics (not the port's setting; a measurement for the next
        # lever: the heuristics pick a slow direct kernel for some dilated
        # convolutions)
        torch.backends.cudnn.benchmark = True
        for _ in range(2):
            steps[True](images[:n], masks[:n])
        bench_ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            steps[True](images[:n], masks[:n])
            end.record()
            end.synchronize()
            bench_ms.append(start.elapsed_time(end))
        torch.backends.cudnn.benchmark = False
        print(f"{card} train {label} kernel route with cudnn.benchmark: median of 5 "
              f"{statistics.median(bench_ms):.3f} ms {[round(v, 3) for v in bench_ms]}")
        profile = profile_call(lambda: steps[True](images[:n], masks[:n]),
                               f"train step {label} kernel route, batch {n}",
                               f"chip_smoke_profile_train_{label.lower()}.txt")
        results[label] = dict(
            batch=n, cut=cut, crop=crop, loss_f32=dict(kernel=loss_k, dense=loss_d),
            worst_grad_rel_l2_f32=[worst_g, rel_g[worst_g], tol[worst_g]],
            median_grad_rel_l2_f32=statistics.median(rel_g[n] for n in gated),
            median_f32_vs_f64_rel_l2=statistics.median(rel_64[n] for n in gated),
            worst_param_diff_over_bar_f32=[worst_u, rel_u[worst_u]], qkv_grad_norms=qkv_norms,
            bf16_grad_rel_l2_median=dict(kernel=statistics.median(half_rel[True].values()),
                                         dense=statistics.median(half_rel[False].values())),
            launches=launches, step_ms=ms[True], img_per_s=1e3 * n / ms[True],
            dense_step_ms=ms[False], dense_img_per_s=1e3 * n / ms[False],
            cudnn_benchmark_step_ms=statistics.median(bench_ms),
            rounds={"kernel": step_ms[True], "dense": step_ms[False]},
            peak_memory_gib={"kernel": peak_route[True] / 2**30,
                             "dense": peak_route[False] / 2**30},
            profile=profile)
        del model, steps, state0, images, masks
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------ 8. flagship training
CITY_VALID_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)
CITY_TRAIN, CITY_VAL = 32, 4  # pairs of 1024x2048 in the temporary tree
TRAIN_BATCHES = (8, 16)  # bench.py's bench_train batch, then the YAML's
RUN_NAME = "deeplabv3_plus_xception65_cityscapes_chip_smoke"  # the run's directory name
RATE_COPIES = 4  # the rate's epoch: the train pairs linked 4 times, 8 steps of 16


def link_cityscapes(src, dst, copies):
    """A Cityscapes tree under ``dst`` whose train split holds each train
    pair of ``src`` ``copies`` times under other names (hard links) and
    whose val split is ``src``'s. The port keeps no decoded cache, so the
    loader decodes every copy anew."""
    for sub in ("leftImg8bit", "gtFine"):
        for split in ("train", "val"):
            for city in sorted(os.listdir(os.path.join(src, sub, split))):
                folder = os.path.join(src, sub, split, city)
                out = os.path.join(dst, sub, split, city)
                os.makedirs(out, exist_ok=True)
                for name in sorted(os.listdir(folder)):
                    for c in range(copies if split == "train" else 1):
                        city_, k, rest = name.split("_", 2)
                        os.link(os.path.join(folder, name),
                                os.path.join(out, f"{city_}_{int(k) + 1000 * c:06d}_{rest}"))


def read_json(path):
    """The JSON object in ``path``, or None where there is no such file."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_cityscapes(root, n_train, n_val, seed=0):
    """A Cityscapes tree under ``root``: ``n_train`` train and ``n_val`` val
    pairs of 1024x2048 PNGs from ``seed`` (two cities a split), blobby
    images whose colours follow raw label ids drawn from the 19 valid ids
    and 0 (road the most common), written by 8 threads."""
    import concurrent.futures as cf

    import numpy as np
    from PIL import Image

    ids = np.array((0,) + CITY_VALID_IDS, np.uint8)
    weights = np.full(len(ids), 1.0)
    weights[0], weights[1] = 3.0, 12.0  # unlabelled, road
    weights /= weights.sum()
    palette = np.random.RandomState(seed).randint(0, 256, (256, 3)).astype(np.float32)

    def one(split, k):
        rng = np.random.RandomState(seed + 1 + k + (0 if split == "train" else 100_000))
        labels = ids[rng.choice(len(ids), (1024 // 64, 2048 // 64), p=weights)]
        labels = np.kron(labels, np.ones((64, 64), np.uint8))
        image = palette[labels] + rng.randn(1024, 2048, 3).astype(np.float32) * 12.0
        city = f"city{k % 2}"
        stem = f"{city}_{k:06d}_000019"
        for sub, name, arr in (("leftImg8bit", f"{stem}_leftImg8bit.png",
                                image.clip(0, 255).astype(np.uint8)),
                               ("gtFine", f"{stem}_gtFine_labelIds.png", labels)):
            folder = os.path.join(root, sub, split, city)
            os.makedirs(folder, exist_ok=True)
            Image.fromarray(arr).save(os.path.join(folder, name), compress_level=1)

    jobs = [("train", k) for k in range(n_train)] + [("val", k) for k in range(n_val)]
    with cf.ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(one, *job) for job in jobs]:
            f.result()


def check_entry_768(torch, entrychain, card, dev, gen):
    """The bf16 entry kernel at the Trainer's validation shapes: two
    images of 768x768 against the plain version (phase 3's bar), then one
    image timed beside its bound and the plain version."""
    stem_p, sep_p, skip_p = entry_params(torch, gen, dev)
    x = torch.randn((2, 768, 768, 3), generator=gen).to(dev, torch.bfloat16)
    ref = entrychain.fused_stem_block1_plain(x, stem_p, sep_p, skip_p).float()
    got = entrychain.fused_stem_block1(x, stem_p, sep_p, skip_p).float()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    max_err, max_ref = err.max().item(), ref.abs().max().item()
    mean_err, mean_ref = err.mean().item(), ref.abs().mean().item()
    ok = (torch.isfinite(got).all().item() and max_err <= 3e-2 * max_ref
          and mean_err <= 2e-3 * mean_ref)
    x1 = x[:1].contiguous()
    packed = entrychain.pack_weights(x1, stem_p, sep_p, skip_p)
    ops = entrychain.pack_operands(x1, stem_p, sep_p, skip_p)
    out = torch.empty((1, 192, 192, 128), dtype=x.dtype, device=dev)

    def launch():
        entrychain._launch("entry_stem_block1", True, x1, packed, out, ops)
    ms, hidden = median_ms(torch, launch), median_ms(torch, launch, hide_launch=True)
    plain_ms = median_ms(torch, lambda: entrychain.fused_stem_block1_plain(x1, stem_p, sep_p,
                                                                           skip_p))
    bound_ms, bound_by = entry_bound(1, 768, 768, True, "bfloat16", 2)
    print(f"{card} fused_stem_block1 bfloat16 (2, 768, 768, 3): max|err| {max_err:.6g} (max|ref| "
          f"{max_ref:.6g}), mean|err| {mean_err:.6g} (mean|ref| {mean_ref:.6g}) [max|err| <= 3e-2 "
          f"max|ref|, mean|err| <= 2e-3 mean|ref|: {'ok' if ok else 'FAIL'}]; (1, 768, 768, 3): "
          f"kernel {ms:.4f} ms ({hidden:.4f} launch hidden), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    if not ok:
        fail("fused_stem_block1 bf16 disagrees with its plain version at (2, 768, 768, 3)")
    return dict(max_abs_err=max_err, ms=ms, ms_launch_hidden=hidden, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def city_batches(torch, root, n, dev):
    """``n`` device-augment items of the Cityscapes train split (as the
    Trainer builds them) stacked into one batch dict on ``dev``."""
    import concurrent.futures as cf

    import numpy as np

    from segmentron_tpu_torch.data.dataloader import CitySegmentation
    from segmentron_tpu_torch.data.device_input import DeviceInput

    ds = CitySegmentation(root=root, split="train", mode="train")
    ds.device_input = DeviceInput(ds, ds.DEVICE_CANVAS)
    with cf.ThreadPoolExecutor(8) as pool:
        items = [it[0] for it in pool.map(ds.__getitem__, range(n))]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(dev) for k in items[0]}
    return batch, ds.device_input.pad_label


def flagship_train(torch, card, dev, defaults, counts, profile_call, then=None):
    """Phase 8: DeepLabv3+ / Xception-65 training at full width (16 middle
    blocks, output stride 16) from the flagship YAML on a Cityscapes tree
    written to a temporary directory (``CITY_TRAIN`` train and ``CITY_VAL``
    val pairs of 1024x2048), 768x768 crops augmented on the device.

    (a) The bf16 entry kernel at the validation shapes (``check_entry_768``).
    (b) ``DeviceAugment`` on the card against its plain version on the CPU
    on one batch dict: normalized images within 1e-4 of max|value| (the
    same f32 products, other summation orders), masks equal. (c) The step
    alone (``make_train_step`` with the augment) at batches 8 and 16, bf16,
    for ``TPU.REMAT`` none, dots and full: peak memory, then the median of
    10 steps by CUDA events, 5 a mode in turns in two rounds; the launch
    counters around one step (no kernel in training); one profiled step at
    batch 16. Cross-checks from the same weights, batch and dropout state:
    in bf16 every mode's loss equal to "none"'s within 1e-3 relative (the
    forward is the same in every mode; only the backward recomputes), in
    f32 at batch 2 (TF32 off) every mode's update of all parameters within
    relative L2 max(1e-4, 4 x the distance of a repeated "none" step) of
    "none"'s, and the BN running statistics within 1e-5 of max|value|:
    cuDNN's algorithms may differ between calls (and its weight gradients
    add with atomics), so equality is not required on the card. (d) The
    entry point as a user runs it: ``tools.train.main`` with the flagship
    YAML, ``TRAIN.EPOCHS 2``, ``TRAIN.BACKBONE_PRETRAINED False`` and the
    least-memory ``TPU.REMAT`` that fits batch 16 ("none" if it fits):
    4 steps of batch 16, a snapshot and a validation each epoch, the launch
    counters set to 0 before it and read after it (the entry kernel 0
    times in training, once an eval batch in validation); then ``--resume``
    with ``TRAIN.EPOCHS 3``: the step counter goes on at 4, ``best_meta``
    is read, epoch 3 runs. The log goes to ``OUT_DIR``; its loss, lr and
    img/s lines are printed. (e) The validation images in f32 through the
    entry kernel against the plain entry modules, for the trained model and
    for the seed's (the trained one predicts road nearly everywhere after
    six steps): logits within 1e-3 of max(1, max|logit|) (phase 4's bar),
    argmax agreement >= 0.995, the classes each route predicts (the seed
    model must predict more than one) and both confusion matrices. (f) The
    Trainer's rate over one epoch of 8 steps of batch 16 (``tools.train``
    again, ``--skip-val``, 128 train items: each written pair linked 4
    times), img/s per step and the median of steps 3-8, beside one item's
    host decode time on one thread. ``then(tmp, snapshots)``, when given,
    runs on the tree and the snapshots before they are removed."""
    import contextlib
    import re
    import tempfile

    import numpy as np

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.engine import make_train_step
    from segmentron_tpu_torch.engine import trainer as trainer_mod
    from segmentron_tpu_torch.models import get_segmentation_model
    from segmentron_tpu_torch.ops import entrychain
    from segmentron_tpu_torch.ops.preprocess import DeviceAugment
    from segmentron_tpu_torch.solver import get_lr_scheduler, get_optimizer, get_segmentation_loss
    from segmentron_tpu_torch.tools import train as train_tool
    from segmentron_tpu_torch.utils import confusion_matrix_update

    zero_counts, read_counts = counts
    results = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        root = os.path.join(tmp, "datasets", "cityscapes")
        t0 = time.perf_counter()
        write_cityscapes(root, CITY_TRAIN, CITY_VAL)
        print(f"{card} flagship train: wrote {CITY_TRAIN} train and {CITY_VAL} val pairs of "
              f"1024x2048 PNGs in {time.perf_counter() - t0:.1f} s")
        gen = torch.Generator().manual_seed(8)
        results["entry_768"] = check_entry_768(torch, entrychain, card, dev, gen)

        load_cfg(cfg, defaults, FLAGSHIP, [])
        crop, batch_max = int(cfg.TRAIN.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
        batch, pad = city_batches(torch, root, batch_max, dev)
        augment = DeviceAugment(crop, list(cfg.DATASET.MEAN), list(cfg.DATASET.STD), pad)

        # ---- (b) the augment on the card against the CPU
        img_d, mask_d = augment.apply(batch)
        img_c, mask_c = augment.apply({k: v.cpu() for k, v in batch.items()})
        aug_err = (img_d.cpu() - img_c).abs().max().item()
        aug_scale = img_c.abs().max().item()
        masks_equal = torch.equal(mask_d.cpu(), mask_c)
        aug_ms = median_ms(torch, lambda: augment.apply(batch), n=10, warmup=2)
        geom = batch["aug_geom"].cpu()
        print(f"{card} DeviceAugment batch {batch_max} of {tuple(batch['image'].shape[1:])} "
              f"uint8 -> {crop}x{crop}: card vs CPU max|err| {aug_err:.6g} (max|value| "
              f"{aug_scale:.6g}) [<= 1e-4 max|value|], masks equal {masks_equal}; flips "
              f"{int(geom[:, 6].sum())}, padded {int((torch.minimum(geom[:, 2], geom[:, 3]) < crop).sum())}, "
              f"blurred {int((batch['aug_sigma'] > 0).sum())}; {aug_ms:.3f} ms on the card")
        if not (aug_err <= 1e-4 * aug_scale and masks_equal):
            fail("DeviceAugment on the card differs from its plain version on the CPU")
        results["augment"] = dict(max_abs_err=aug_err, scale=aug_scale, ms=aug_ms)
        del img_d, mask_d, img_c, mask_c

        # ---- (c) the step alone, per remat mode
        model = get_segmentation_model(dev, generator=torch.Generator().manual_seed(int(cfg.SEED)))
        loss_fn = get_segmentation_loss(
            cfg.MODEL.MODEL_NAME, use_ohem=cfg.SOLVER.OHEM, aux=cfg.SOLVER.AUX,
            aux_weight=cfg.SOLVER.AUX_WEIGHT, loss_name=cfg.SOLVER.LOSS_NAME,
            ohem_thresh=cfg.SOLVER.OHEM_THRESH, ohem_min_kept=cfg.SOLVER.OHEM_MIN_KEPT)
        schedule = get_lr_scheduler(cfg, 100)
        state0 = {k: v.clone() for k, v in model.state_dict().items()}
        generator = torch.Generator(device=dev).manual_seed(int(cfg.SEED))

        def make_step(dtype, remat):
            model.load_state_dict(state0)
            return make_train_step(model, loss_fn, get_optimizer(cfg, model, schedule), schedule,
                                   compute_dtype=dtype, remat=remat, device=dev,
                                   generator=generator, augment=augment)

        def sub(n):
            return {k: v[:n] for k, v in batch.items()}

        modes = ("none", "dots", "full")
        step = make_step(cfg.TPU.COMPUTE_DTYPE, "none")
        zero_counts()
        step(sub(2))
        torch.cuda.synchronize()
        step_launches = read_counts()
        print(f"{card} train step launches (one bf16 step): {step_launches} [none]")
        if any(step_launches.values()):
            fail(f"a train step launched a kernel: {step_launches}")
        g0 = generator.get_state()
        losses16 = {}
        for mode in modes:  # the same weights, batch and dropout state
            step = make_step(cfg.TPU.COMPUTE_DTYPE, mode)
            generator.set_state(g0)
            losses16[mode] = step(sub(2)).item()
        rel16 = {m: abs(losses16[m] - losses16["none"]) / abs(losses16["none"]) for m in modes}
        print(f"{card} train step bf16 batch 2: loss per remat mode {losses16} [rel to none "
              f"<= 1e-3: {rel16}]")
        if max(rel16.values()) > 1e-3 or not all(math.isfinite(v) for v in losses16.values()):
            fail("the remat modes' bf16 losses differ")

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        updates, stats = {}, {}
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        for mode in ("none", "dots", "full", "none"):
            step = make_step("float32", mode)
            generator.set_state(g0)
            step(sub(2))
            u = torch.cat([(p.detach() - p0[n]).flatten() for n, p in model.named_parameters()])
            s = torch.cat([b.flatten() for n, b in model.named_buffers() if "running" in n])
            if mode in updates:
                updates["none again"], stats["none again"] = u, s
            else:
                updates[mode], stats[mode] = u, s
        torch.backends.cudnn.allow_tf32 = True
        unorm = updates["none"].norm().item()
        rel_u = {m: (updates[m] - updates["none"]).norm().item() / unorm for m in updates}
        rel_s = {m: (stats[m] - stats["none"]).abs().max().item()
                 / stats["none"].abs().max().item() for m in stats}
        bar = max(1e-4, 4 * rel_u["none again"])
        print(f"{card} train step f32 batch 2 (TF32 off): update rel L2 vs none {rel_u} [<= "
              f"{bar:.3g}], running statistics max|diff| / max|value| {rel_s} [<= 1e-5]")
        if max(rel_u[m] for m in ("dots", "full")) > bar or max(rel_s.values()) > 1e-5:
            fail("the remat modes' f32 updates or BN statistics differ from none's")
        del updates, stats, p0

        step = make_step(cfg.TPU.COMPUTE_DTYPE, "none")
        peaks, step_ms = {}, {}
        for n in TRAIN_BATCHES:
            fits = []
            for mode in modes:
                step.remat = mode
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                try:
                    for _ in range(2):
                        step(sub(n))
                    torch.cuda.synchronize()
                    peaks[(n, mode)] = torch.cuda.max_memory_allocated() / 2**30
                    fits.append(mode)
                except torch.cuda.OutOfMemoryError:
                    peaks[(n, mode)] = None
                    print(f"{card} train step batch {n} remat {mode}: out of memory")
            times = {mode: [] for mode in fits}
            for rnd in range(2):
                for mode in (fits if rnd == 0 else fits[::-1]):
                    step.remat = mode
                    for _ in range(5):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        loss = step(sub(n))
                        end.record()
                        end.synchronize()
                        times[mode].append(start.elapsed_time(end))
                    if not math.isfinite(loss.item()):
                        fail(f"train step batch {n} remat {mode}: non-finite loss")
            for mode in fits:
                step_ms[(n, mode)] = statistics.median(times[mode])
            print(f"{card} train step bf16, batch {n} of {crop}x{crop}, device augment in the "
                  f"step, ms (img/s), median of 10 in turns; peak memory: " + "; ".join(
                      f"{m} {step_ms[(n, m)]:.3f} ({1e3 * n / step_ms[(n, m)]:.2f}) "
                      f"{[round(v, 2) for v in times[m]]} {peaks[(n, m)]:.3f} GiB"
                      if m in fits else f"{m} out of memory" for m in modes))
        remat = next((m for m in modes if step_ms.get((batch_max, m)) is not None), None)
        if remat is None:
            fail(f"no TPU.REMAT mode fits batch {batch_max}")
        step.remat = remat
        profile = profile_call(lambda: step(sub(batch_max)),
                               f"flagship train step, bf16, batch {batch_max}, remat {remat}",
                               "chip_smoke_profile_flagship_train.txt")
        results["step"] = dict(
            remat_used=remat, losses_bf16=losses16, update_rel_l2_f32=rel_u,
            stats_rel_f32=rel_s, launches=step_launches,
            ms={f"{n} {m}": v for (n, m), v in step_ms.items()},
            peak_gib={f"{n} {m}": v for (n, m), v in peaks.items()}, profile=profile)
        del model, step, state0, batch
        torch.cuda.empty_cache()

        # ---- (d) the entry point, then resume
        real_validate, real_resume = trainer_mod.Trainer.validate, trainer_mod.Trainer._resume
        seen = dict(val=[], trainers=[], resumed=[])

        def validate(self):
            before = read_counts()["fused_stem_block1"]
            out = real_validate(self)
            torch.cuda.synchronize()
            seen["val"].append((read_counts()["fused_stem_block1"] - before, len(self.val_loader)))
            seen["trainers"].append(self)
            return out

        def resume(self):
            real_resume(self)
            seen["resumed"].append((self.train_step.updates, self.start_epoch, self.best_miou))

        save_dir, log_dir = os.path.join(tmp, "runs"), os.path.join(tmp, "logs")
        meta1 = None
        opts = ["ROOT_PATH", tmp, "TIME_STAMP", "chip_smoke", "TRAIN.EPOCHS", "2",
                "TRAIN.BACKBONE_PRETRAINED", "False", "TRAIN.MODEL_SAVE_DIR", save_dir,
                "TRAIN.LOG_SAVE_DIR", log_dir, "TPU.REMAT", remat]
        log_path = os.path.join(OUT_DIR, "chip_smoke_flagship_train_log.txt")
        runs = {}
        trainer_mod.Trainer.validate, trainer_mod.Trainer._resume = validate, resume
        try:
            with open(log_path, "w") as log, contextlib.redirect_stdout(log):
                for name, extra, flags in (("train", [], []),
                                           ("resume", ["TRAIN.EPOCHS", "3"], ["--resume"])):
                    reset_cfg(cfg, defaults)
                    zero_counts()
                    t0 = time.perf_counter()
                    final = train_tool.main(["--config-file", FLAGSHIP, "--log-iter", "2", *flags,
                                             *opts, *extra])
                    torch.cuda.synchronize()
                    runs[name] = dict(final_loss=final, seconds=time.perf_counter() - t0,
                                      launches=read_counts())
                    if name == "train":
                        meta1 = read_json(os.path.join(save_dir, RUN_NAME, "snapshots_best",
                                                       "best_meta.json"))
        finally:
            trainer_mod.Trainer.validate, trainer_mod.Trainer._resume = real_validate, real_resume
        run_dir = os.path.join(save_dir, RUN_NAME)
        log_text = open(log_path).read()
        keep = re.compile(r"Epoch \d+/\d+ iter|Epoch \d+: |Validation epoch|Resumed from|"
                          r"New best|Model params|Device input|Snapshot")
        for line in log_text.splitlines():
            if keep.search(line):
                print(f"{card} {line.split(' INFO: ')[-1]}")
        snapshots = sorted(os.listdir(os.path.join(run_dir, "snapshots")))
        meta_path = os.path.join(run_dir, "snapshots_best", "best_meta.json")
        meta = read_json(meta_path)
        trainer = seen["trainers"][-1]
        n_val = len(trainer.val_loader)
        val_launches = [v for v, _ in seen["val"]]
        train_launches = {name: r["launches"]["fused_stem_block1"] for name, r in runs.items()}
        ips = [float(m) for m in re.findall(r"\| ([0-9.]+) img/s", log_text)]
        waits = re.findall(r"Epoch (\d+): (\d+) steps in ([0-9.]+) s, ([0-9.]+) s of it waiting",
                           log_text)
        print(f"{card} flagship train through tools.train (remat {remat}): final losses "
              f"{[round(r['final_loss'], 6) for r in runs.values()]}, {[round(r['seconds'], 1) for r in runs.values()]} s; "
              f"snapshots {snapshots}; best_meta after the first run {meta1}, after the resumed "
              f"run {meta}; resumed at (step, epoch, best mIoU) "
              f"{seen['resumed']}; entry kernel launches per validation {val_launches} "
              f"({n_val} eval batches each), per run {train_launches}; img/s per logged step "
              f"{ips}; loader wait per epoch {waits}")
        want_val = [n_val] * 3
        other = {k: v for r in runs.values() for k, v in r["launches"].items()
                 if k != "fused_stem_block1" and v}
        if not all(math.isfinite(r["final_loss"]) for r in runs.values()):
            fail("flagship train: non-finite loss")
        if snapshots != ["step_2.pt", "step_4.pt", "step_6.pt"] or meta1 is None or meta is None:
            fail("flagship train: snapshots or best_meta.json missing")
        if val_launches != want_val or sum(train_launches.values()) != sum(want_val) or other:
            fail(f"flagship train: entry kernel launches {val_launches} in validation, "
                 f"{train_launches} a run (want {want_val}: none in training), others {other}")
        if seen["resumed"] != [(4, 2, meta1["miou"])]:
            fail(f"flagship train: resume read {seen['resumed']}, best_meta {meta1}")
        results["trainer"] = dict(remat=remat, runs=runs, snapshots=snapshots,
                                  best_meta=[meta1, meta],
                                  resumed=seen["resumed"], validation_launches=val_launches,
                                  img_per_s=ips, loader_wait=waits)

        # ---- (e) validation through the kernel against the plain twin, f32,
        # on the trained model and on the seed's: six steps from scratch
        # leave a model that predicts road nearly everywhere, where an
        # argmax agreement tells little, so the logits are held too and the
        # seed model must predict more than one class
        models = {"trained": trainer.model,
                  "seed": get_segmentation_model(
                      dev, generator=torch.Generator().manual_seed(int(cfg.SEED)))}
        twin = {}
        torch.backends.cudnn.allow_tf32 = False
        for name, model in models.items():
            model.eval()
            bb = model.backbone
            logits, cms = {}, {}
            with torch.no_grad():
                for route in ("block1", False):
                    bb.fused_stem = route
                    zero_counts()
                    cms[route], logits[route] = 0, []
                    for b in trainer.val_loader:
                        out = model(b["image"])[0]
                        cms[route] = cms[route] + confusion_matrix_update(
                            out.argmax(-1), b["mask"], trainer.nclass).cpu().numpy()
                        logits[route].append(out)
                    launches = read_counts()["fused_stem_block1"]
                    if launches != (n_val if route else 0):
                        fail(f"f32 validation {name} route {route}: {launches} entry kernel "
                             "launches")
            bb.fused_stem = cfg.TPU.FUSED_STEM
            got, ref = torch.cat(logits["block1"]), torch.cat(logits[False])
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            scale = max(1.0, ref.abs().max().item())
            err = (got - ref).abs().max().item()
            classes = {str(r): len(torch.unique(torch.cat(logits[r]).argmax(-1)))
                       for r in ("block1", False)}
            moved = int(np.abs(cms["block1"] - cms[False]).sum()) // 2
            print(f"{card} flagship validation f32, {name} model ({n_val} images of "
                  f"{crop}x{crop}): entry kernel vs plain entry modules: logits max|err| "
                  f"{err:.6g} (scale max(1, max|logit|) {scale:.6g}) [<= 1e-3 scale, phase 4's "
                  f"bar], argmax agreement {agree:.6f} [>= 0.995], classes predicted "
                  f"{classes}; confusion matrices total {int(cms[False].sum())}, {moved} "
                  f"pixels in other cells")
            if not (torch.isfinite(got).all() and err <= 1e-3 * scale and agree >= 0.995):
                fail(f"flagship validation, {name} model: the entry kernel disagrees with the "
                     "plain entry modules")
            if name == "seed" and classes["False"] < 2:
                fail("flagship validation: the seed model predicts one class, so the twin "
                     "check cannot tell the routes apart")
            twin[name] = dict(argmax_agreement=agree, logits_max_abs_err=err, scale=scale,
                              classes=classes, cm_pixels_moved=moved)
            del logits, got, ref
        torch.backends.cudnn.allow_tf32 = True
        results["validation_twin"] = twin
        del models, model

        # ---- (f) the Trainer's rate over an epoch of 8 steps
        rate_tmp = os.path.join(tmp, "rate")
        link_cityscapes(root, os.path.join(rate_tmp, "datasets", "cityscapes"), RATE_COPIES)
        real_train = trainer_mod.Trainer.train
        rate_trainers = []

        def train(self):
            rate_trainers.append(self)
            return real_train(self)

        trainer_mod.Trainer.train = train
        try:
            with open(log_path, "a") as log, contextlib.redirect_stdout(log):
                reset_cfg(cfg, defaults)
                t0 = time.perf_counter()
                train_tool.main(["--config-file", FLAGSHIP, "--log-iter", "1", "--skip-val",
                                 "ROOT_PATH", rate_tmp, "TIME_STAMP", "chip_smoke_rate",
                                 "TRAIN.EPOCHS", "1", "TRAIN.BACKBONE_PRETRAINED", "False",
                                 "TRAIN.MODEL_SAVE_DIR", os.path.join(rate_tmp, "runs"),
                                 "TRAIN.LOG_SAVE_DIR", os.path.join(rate_tmp, "logs"),
                                 "TPU.REMAT", remat])
                torch.cuda.synchronize()
                rate_s = time.perf_counter() - t0
        finally:
            trainer_mod.Trainer.train = real_train
        rate_text = open(log_path).read()[len(log_text):]
        step_ips = [float(m) for m in re.findall(r"\| ([0-9.]+) img/s", rate_text)]
        epoch = re.findall(r"Epoch 1: (\d+) steps in ([0-9.]+) s, ([0-9.]+) s of it waiting",
                           rate_text)
        rate_trainer = rate_trainers[-1]
        dataset = rate_trainer.train_dataset
        decode_ms = []
        for i in range(8):  # one item at a time on this thread, as one loader worker
            t0 = time.perf_counter()
            dataset[i]
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        steady = statistics.median(step_ips[2:]) if len(step_ips) > 2 else float("nan")
        workers = int(cfg.DATASET.WORKERS)
        print(f"{card} Trainer rate over one epoch of {len(step_ips)} steps of batch "
              f"{batch_max} ({len(dataset)} train items, {RATE_COPIES} links of each written "
              f"pair, each decoded anew), remat {remat}, DATASET.WORKERS {workers}, "
              f"TPU.PREFETCH {int(cfg.TPU.PREFETCH)}: img/s per step {step_ips}, median of "
              f"steps 3-{len(step_ips)} {steady:.2f}; epoch (steps, s, s waiting for the "
              f"loader) {epoch}; run {rate_s:.1f} s; one item's host decode and draw on one "
              f"thread, ms {[round(v, 1) for v in decode_ms]} (median "
              f"{statistics.median(decode_ms):.1f}: {workers} workers give at most "
              f"{1e3 * workers / statistics.median(decode_ms):.2f} img/s)")
        if len(step_ips) != len(dataset) // batch_max or not math.isfinite(steady):
            fail(f"Trainer rate: {len(step_ips)} steps logged for {len(dataset)} items")
        results["trainer_rate"] = dict(
            img_per_s_per_step=step_ips, img_per_s_steady=steady, epoch=epoch,
            seconds=rate_s, decode_ms=decode_ms, workers=workers)
        del rate_trainer, rate_trainers, dataset
        del trainer, seen
        torch.cuda.empty_cache()
        if then is not None:  # phase 9 on this tree and these snapshots
            results["then"] = then(tmp, os.path.join(run_dir, "snapshots"))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return results


# ------------------------------------------------ 9. evaluation and int8 serving
# The serving YAMLs as written but for the dataset and TEST.CROP_SIZE: their
# [1024, 2048] is a list, which the JAX Evaluator's int(crop) refuses;
# 2048 is the int it can read with the same effect at 1024x2048 (the whole
# frame, no sliding window). Neither package's cfg takes a scalar over a
# list from KEY VALUE pairs, so in process the list is cleared first, and
# the tool reads a copy of the YAML with the int (SERVE_CROP).
SERVE_OPTS = ["DATASET.NAME", "synthetic", "TEST.CROP_SIZE", None, "TEST.CROP_SIZE", 2048]
SERVE_CROP = ("CROP_SIZE: [1024, 2048]", "CROP_SIZE: 2048")
# The JAX package's own int8-vs-f32 argmax agreement at the CPU test's
# size (tests/test_torch_int8_resnet.py: 4 blocks) sets no bar at full
# depth, where the int8 noise of 33 blocks of random weights is far larger.
# The bar is the JAX package's int8-vs-f32 agreement on these weights at
# full width and depth at 256x512 on the CPU (python tests/int8_agreement.py;
# PERF.md), less INT8_AGREE_MARGIN for the cut image and bf16.
INT8_AGREE_CPU = {"DANet": 0.9595794677734375, "OCNet": 0.913330078125}
INT8_AGREE_MARGIN = 0.05
EVAL_RUNS = [  # phase 9 (c): (label, tools.eval flags, KEY VALUE overrides)
    ("flagship", [], []),
    ("flagship --best", ["--best"], []),
    ("scales 0.75/1/1.25 + flip", [], ["TEST.SCALES", "[0.75, 1.0, 1.25]", "TEST.FLIP", "True"]),
    ("sliding crop 769", [], ["TEST.CROP_SIZE", "769"]),
]
CM_MOVED = 0.005  # phase 4's argmax bar (>= 0.995) as a share of the CM's pixels


def drop_port_log_handlers():
    """Detach the port's log handlers, which a tool run under
    ``redirect_stdout`` bound to a log file that is closed after it."""
    import logging

    logger = logging.getLogger("segmentron_tpu_torch")
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()


def attention_model(torch, dev, cfg):
    """DANet or OCNet as the cfg names it, random weights from the seed,
    BN statistics drawn as for the flagship and ``gamma = GAMMA``; returns
    (model, the number of gammas)."""
    from segmentron_tpu_torch.models import get_segmentation_model

    gen = torch.Generator().manual_seed(int(cfg.SEED))
    model = get_segmentation_model(dev, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) * 0.5 + 0.75)
        gammas = [p for n, p in model.named_parameters() if n.endswith("gamma")]
        for p in gammas:
            p.fill_(GAMMA)
    return model, len(gammas)


def record_qconvs(torch, predict, image):
    """{(C, O, k, stride, dilation): (the call's QTensor, weight, quantized
    pair, stride, padding, dilation, output hw)} of the first ``qconv``
    call of each distinct shape in one forward of ``predict``."""
    from segmentron_tpu_torch.models.backbones import resnet

    seen, real = {}, resnet.qconv

    def recording(x, w, stride=1, padding=None, dilation=1, **kw):
        out = real(x, w, stride, padding, dilation, **kw)
        key = (x.q.shape[-1], w.shape[-1], w.shape[0], tuple(stride), tuple(dilation))
        if key not in seen:
            hw = tuple((out.q if hasattr(out, "q") else out).shape[1:3])
            seen[key] = (x, w, kw["quantized"], tuple(stride), tuple(padding), tuple(dilation),
                         tuple(x.q.shape[1:3]), hw)
        return out

    resnet.qconv = recording
    try:
        with torch.inference_mode():
            predict(image)
    finally:
        resnet.qconv = real
    return seen


def check_qconv_products(torch, card, dev, calls):
    """Phase 9 (a): at every distinct int8 conv of ResNet-101 at output
    stride 8 (recorded from a DANet forward at 1024x2048), the int32
    accumulators of the CUDA route (``torch._int_mm`` over the gathered
    taps) bitwise equal to the plain version's (a float64 product on the
    CPU), the f32 output ``acc * s_w`` within one f32 ulp of the plain
    one, and the product's time beside the bf16 ``F.conv2d`` it replaces
    (channels-last, cuDNN) and its bound."""
    import torch.nn.functional as F

    from segmentron_tpu_torch.ops.quant import qconv, qconv_acc

    results = {}
    for key, (x, w, quantized, stride, padding, dilation, in_hw, out_hw) in sorted(calls.items()):
        c, o, k = key[:3]
        w_mat, s_w = quantized
        acc = qconv_acc(x.q, w_mat, (k, k), stride, padding, dilation)
        plain = qconv_acc(x.q.cpu(), w_mat.cpu(), (k, k), stride, padding, dilation)
        y = qconv(x, w, stride, padding, dilation, quantized=quantized)
        torch.cuda.synchronize()
        ref = plain.float() * s_w.cpu()
        ulp = torch.finfo(torch.float32).eps * ref.abs().clamp(min=torch.finfo(torch.float32).tiny)
        acc_equal = torch.equal(acc.cpu(), plain)
        y_err = ((y.cpu() - ref).abs() / ulp).max().item()
        xb = torch.randn((1, c) + in_hw, device=dev, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wb = torch.randn((o, c, k, k), device=dev, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        ms = median_ms(torch, lambda: qconv_acc(x.q, w_mat, (k, k), stride, padding, dilation))
        epi_ms = median_ms(torch, lambda: qconv(x, w, stride, padding, dilation,
                                                quantized=quantized))
        conv_ms = median_ms(torch, lambda: F.conv2d(xb, wb, None, stride, padding, dilation))
        m = out_hw[0] * out_hw[1]
        ops = 2 * m * k * k * c * o
        bytes_ = in_hw[0] * in_hw[1] * c + k * k * c * o + 4 * m * o  # int8 in, int32 out
        bound = max(ops / PEAK_OPS["int8"], bytes_ / PEAK_BYTES) * 1e3
        print(f"{card} qconv (C {c}, O {o}, k {k}, stride {stride[0]}, dilation {dilation[0]}) "
              f"{in_hw} -> {out_hw}: int32 accumulators CUDA == plain: {acc_equal}; f32 output "
              f"max err {y_err:.3f} ulp [<= 1]; product (taps + torch._int_mm) {ms:.4f} ms, with "
              f"the f32 epilogue {epi_ms:.4f} ms, bf16 F.conv2d {conv_ms:.4f} ms, bound "
              f"{bound:.4f} ms")
        if not acc_equal or y_err > 1.0:
            fail(f"qconv {key}: the CUDA route differs from the plain version")
        results["x".join(map(str, key[:3])) + f"_s{stride[0]}_d{dilation[0]}"] = dict(
            in_hw=in_hw, out_hw=out_hw, ms=ms, epilogue_ms=epi_ms, conv2d_bf16_ms=conv_ms,
            bound_ms=bound, acc_equal=acc_equal, f32_ulp=y_err)
    return results


def serving_forwards(torch, card, dev, defaults, counts, profile_call):
    """Phase 9 (a) and (b): DANet and OCNet from the serving YAMLs with
    ``TPU.INT8_RESNET`` on (``SERVE_OPTS``), ResNet-101 at output stride 8,
    1024x2048, batch 1, bf16, random weights as in phase 6. Each model's
    int8-interior forward and its bf16 forward (the same weights, int8
    off) with the flash-attention launches counted in both; argmax
    agreement and max|d logit| of int8 against bf16, held to
    ``INT8_AGREE_CPU`` less ``INT8_AGREE_MARGIN``; both forwards timed in
    turns (int8, bf16, bf16, int8; median of 20 by CUDA events each), their
    peak memory and one profiled int8 forward. DANet's forward first feeds
    (a)."""
    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import make_predict_fn
    from segmentron_tpu_torch.models.backbones.resnet import int8_resnet_k, set_int8_resnet

    zero_counts, read_counts = counts
    data = SyntheticSegmentation(split="val", mode="testval", length=1, image_size=SHAPE[1:3])
    image = torch.from_numpy(data[0][0][None]).to(dev)
    results = {}
    for name in ("DANet", "OCNet"):
        load_cfg(cfg, defaults, ATTENTION_MODELS[name], SERVE_OPTS)
        k = int8_resnet_k(cfg)
        if k is None:
            fail(f"{name}: the serving YAML does not switch TPU.INT8_RESNET on")
        model, _ = attention_model(torch, dev, cfg)
        predict = make_predict_fn(model, cfg.TPU.COMPUTE_DTYPE, dev)
        if name == "DANet":
            results["qconv"] = check_qconv_products(torch, card, dev,
                                                    record_qconvs(torch, predict, image))
        logits, launches, peak = {}, {}, {}
        with torch.inference_mode():
            for mode, int8_k in (("int8", k), ("bf16", None)):
                set_int8_resnet(model, int8_k)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                logits[mode] = predict(image)
                torch.cuda.synchronize()
                launches[mode] = read_counts()
                peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
            times = {"int8": [], "bf16": []}
            for mode in ("int8", "bf16", "bf16", "int8"):
                set_int8_resnet(model, k if mode == "int8" else None)
                times[mode].append(median_ms(torch, lambda: predict(image), n=20, warmup=3))
            set_int8_resnet(model, k)
            profile = profile_call(lambda: predict(image), f"one int8 forward, {name} serving "
                                   f"YAML, bf16, 1x{SHAPE[1]}x{SHAPE[2]}",
                                   f"chip_smoke_profile_{name.lower()}_int8.txt")
        for mode, lg in logits.items():
            if lg.shape != (1, SHAPE[1], SHAPE[2], model.nclass) or not torch.isfinite(lg).all():
                fail(f"{name} {mode}: logits {tuple(lg.shape)} or non-finite")
            others = {key: v for key, v in launches[mode].items() if v and key != "flash_attention"}
            if launches[mode]["flash_attention"] != 1 or others:
                fail(f"{name} {mode}: launches {launches[mode]}, want flash_attention once")
        agree = (logits["int8"].argmax(-1) == logits["bf16"].argmax(-1)).float().mean().item()
        max_d = (logits["int8"] - logits["bf16"]).abs().max().item()
        scale = logits["bf16"].abs().max().item()
        ms = {mode: statistics.mean(v) for mode, v in times.items()}
        bar = INT8_AGREE_CPU[name] - INT8_AGREE_MARGIN
        print(f"{card} {name} serving YAML, int8 interiors (INT8_K {k}) vs bf16, (1, {SHAPE[1]}, "
              f"{SHAPE[2]}, 3): argmax agreement {agree:.6f} [>= {bar:.4f}], max|d logit| "
              f"{max_d:.6g} (max|logit| {scale:.6g}); forward ms (img/s), median of 20 in turns: "
              f"int8 {ms['int8']:.3f} ({1e3 / ms['int8']:.2f}) {[round(v, 3) for v in times['int8']]}, "
              f"bf16 {ms['bf16']:.3f} ({1e3 / ms['bf16']:.2f}) {[round(v, 3) for v in times['bf16']]}; "
              f"peak memory int8 {peak['int8']:.3f} GiB, bf16 {peak['bf16']:.3f} GiB; flash "
              f"launches int8 {launches['int8']['flash_attention']}, bf16 "
              f"{launches['bf16']['flash_attention']}")
        if agree < bar:
            fail(f"{name}: the int8 forward's argmax agrees with the bf16 forward's on less than "
                 f"{bar:.4f} of the pixels")
        results[name] = dict(argmax_agreement=agree, max_abs_d_logit=max_d, max_abs_logit=scale,
                             forward_ms=ms, rounds=times, peak_gib=peak, profile=profile,
                             launches=launches["int8"]["flash_attention"]
                             + launches["bf16"]["flash_attention"])
        del model, predict, logits
        torch.cuda.empty_cache()
    return results


def eval_tool_runs(torch, card, defaults, counts, tmp, snapshots):
    """Phase 9 (c): ``segmentron_tpu_torch.tools.eval`` as a user runs it,
    over the Cityscapes val pairs under ``tmp``, on the snapshots in
    ``snapshots`` (``TEST.TEST_MODEL_PATH``): the flagship YAML as written
    (latest snapshot, then ``--best``), with multi-scale and flip TTA, and
    with a 769 sliding window (``EVAL_RUNS``), the launch counters set to 0
    before each and read after it. Each run's confusion matrix is held to
    an in-process ``Evaluator`` on the plain routes (the entry modules, no
    kernel) of the same cfg and weights: at most ``CM_MOVED`` of the pixels
    moved. Printed: mIoU, img/s, entry launches per image and the input
    shapes whose entry gate (``stem_block1_supported``) refuses them. Then
    the DANet serving YAML once through the tool (a copy with the crop of
    ``SERVE_CROP``; no snapshot: random weights), its flash launches
    counted (one an image)."""
    import contextlib
    import types

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.engine import Evaluator
    from segmentron_tpu_torch.models.backbones import xception
    from segmentron_tpu_torch.tools import eval as eval_tool

    zero_counts, read_counts = counts
    gate, real_gate = [], xception.Xception65._fused_stem_mode
    eval_seconds, real_eval = [], Evaluator.eval

    def timed_eval(self):
        t0 = time.perf_counter()
        out = real_eval(self)
        torch.cuda.synchronize()
        eval_seconds.append(time.perf_counter() - t0)
        return out

    def recording_gate(self, x):
        mode = real_gate(self, x)
        gate.append((tuple(x.shape), mode))
        return mode

    results = {}
    log_path = os.path.join(OUT_DIR, "chip_smoke_eval_log.txt")
    xception.Xception65._fused_stem_mode = recording_gate
    Evaluator.eval = timed_eval
    try:
        with open(log_path, "w") as log:
            for label, flags, extra in EVAL_RUNS + [("DANet serving YAML", [], None)]:
                if extra is None:
                    text = open(ATTENTION_MODELS["DANet"]).read()
                    if SERVE_CROP[0] not in text:
                        fail(f"{ATTENTION_MODELS['DANet']} no longer sets {SERVE_CROP[0]}")
                    yaml = os.path.join(tmp, "serve_danet_crop2048.yaml")
                    with open(yaml, "w") as f:
                        f.write(text.replace(*SERVE_CROP))
                    argv = ["--config-file", yaml, "ROOT_PATH", tmp, "TIME_STAMP",
                            "chip_smoke_eval"]
                else:
                    argv = ["--config-file", FLAGSHIP, *flags, "ROOT_PATH", tmp, "TIME_STAMP",
                            "chip_smoke_eval", "TEST.TEST_MODEL_PATH", snapshots, *extra]
                reset_cfg(cfg, defaults)
                gate.clear()
                with contextlib.redirect_stdout(log):
                    zero_counts()
                    eval_seconds.clear()
                    t0 = time.perf_counter()
                    tool = eval_tool.main(argv)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    loop = eval_seconds[0]  # Evaluator.eval: the loader, TTA and scoring
                    launches = read_counts()
                    n_img = len(tool.dataset)
                    cm = tool.metric.confusion_matrix
                    pix_acc, miou, _ = tool.metric.get(return_category_iou=True)
                    seen = sorted(set(gate))
                    if extra is not None:  # the plain twin: same cfg (frozen) and weights
                        plain = Evaluator(args=types.SimpleNamespace(best="--best" in flags))
                        plain.model.backbone.fused_stem = False
                        plain.eval()
                        plain_cm = plain.metric.confusion_matrix
                        del plain
                del tool
                torch.cuda.empty_cache()
                labelled = int(cm.sum())
                refused = [shape for shape, mode in seen if mode != "block1"]
                if extra is None:
                    print(f"{card} tools.eval {label} ({' '.join(argv)}): "
                          f"{n_img} images, eval loop {loop:.3f} s ({n_img / loop:.3f} img/s), "
                          f"the whole tool {seconds:.3f} s; mIoU {miou:.6f}; flash launches "
                          f"{launches['flash_attention']}")
                    if launches["flash_attention"] != n_img or labelled == 0:
                        fail(f"tools.eval {label}: flash launches {launches}")
                    results[label] = dict(images=n_img, seconds=seconds, eval_seconds=loop,
                                          img_per_s=n_img / loop, miou=miou,
                                          launches=launches["flash_attention"])
                    continue
                moved = int(abs(cm - plain_cm).sum()) // 2
                entry = launches["fused_stem_block1"]
                print(f"{card} tools.eval {label}: {n_img} images, eval loop {loop:.3f} s "
                      f"({n_img / loop:.3f} img/s with the PNG decode), the whole tool "
                      f"{seconds:.3f} s; pixAcc {pix_acc:.6f}, mIoU {miou:.6f}; entry kernel launches "
                      f"{entry} ({entry / n_img:.2f} an image); forward shapes and the entry "
                      f"gate {seen}, refused {refused}; CM vs the plain routes: {moved} of "
                      f"{labelled} pixels moved [<= {CM_MOVED}]")
                if moved > CM_MOVED * labelled or labelled == 0:
                    fail(f"tools.eval {label}: the confusion matrix moved {moved} pixels from "
                         f"the plain routes'")
                if entry != sum(1 for shape, mode in gate if mode == "block1") or (
                        not refused and entry == 0):
                    fail(f"tools.eval {label}: {entry} entry launches for the gate's {seen}")
                results[label] = dict(images=n_img, seconds=seconds, eval_seconds=loop,
                                      img_per_s=n_img / loop,
                                      pix_acc=pix_acc, miou=miou, entry_launches=entry,
                                      shapes=seen, refused=refused, cm_moved=moved)
    finally:
        xception.Xception65._fused_stem_mode = real_gate
        Evaluator.eval = real_eval
        drop_port_log_handlers()
    return results


def eval_phase(torch, card, dev, defaults, counts, tmp, snapshots):
    """Phase 9: (a) and (b) ``serving_forwards``, (c) ``eval_tool_runs``."""
    results = serving_forwards(torch, card, dev, defaults, counts,
                               functools.partial(profile_thunk, torch, card))
    results["tools_eval"] = eval_tool_runs(torch, card, defaults, counts, tmp, snapshots)
    return results


def eval_only(torch, card, dev, defaults, counts):
    """``--eval``: phase 9 alone, on a Cityscapes tree of 16 train and
    ``CITY_VAL`` val pairs and the snapshots of a one-step run of
    ``tools.train`` (with its validation, for the best snapshot)."""
    import contextlib
    import shutil
    import tempfile

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.tools import train as train_tool

    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        write_cityscapes(os.path.join(tmp, "datasets", "cityscapes"), 16, CITY_VAL)
        reset_cfg(cfg, defaults)
        with open(os.path.join(OUT_DIR, "chip_smoke_eval_train_log.txt"), "w") as log, \
                contextlib.redirect_stdout(log):
            train_tool.main(["--config-file", FLAGSHIP, "ROOT_PATH", tmp, "TIME_STAMP",
                             "chip_smoke", "TRAIN.EPOCHS", "1", "TRAIN.BACKBONE_PRETRAINED",
                             "False", "TRAIN.MODEL_SAVE_DIR", os.path.join(tmp, "runs")])
        drop_port_log_handlers()
        torch.cuda.empty_cache()
        return eval_phase(torch, card, dev, defaults, counts, tmp,
                          os.path.join(tmp, "runs", RUN_NAME, "snapshots"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------ the ceiling probe's kernel
PROBE_DOT_SOURCE = "segmentron_tpu_torch/csrc/probe_dot.cu"
PROBE_DOT_REPLACES = "tools/ceiling_probe.py:287 (kern; pallas_dot :262, pallas_call :298)"
# (M, K, N): the probe's two shapes and two ragged ones (K not a multiple of
# the mma's depth, N not of the tile, M not of the block; the last with rows
# of an odd byte count, copied a byte at a time), which take both producers
# (TMA, cp.async) in both types; the last case takes int8's mma.sync route
# (K > 768) and a bf16 K loop of 16 stages. The line's entry: int8 at C = 728,
# the probe's first case.
PROBE_DOT_CASES = [(8192, 728, 728), (8192, 768, 768), (300, 40, 72), (129, 33, 17),
                   (520, 1000, 200)]
PROBE_ITERS = "3"      # CP_ITERS of the probe's model chains here
PROBE_TARGET = "4e11"  # CP_TARGET: a tenth of the tool's default


def probe_dot_bound(m, k, n, dname, itemsize):
    """(ms, 'bytes' | 'operations'): x and w read once, out written once."""
    t_ops = 2 * m * k * n / PEAK_OPS[dname]
    t_bytes = (m * k + k * n + m * n) * itemsize / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def print_ptxas(card, name, log=None, only=None):
    """Registers, shared memory and spills of each kernel specialisation of
    ``csrc/<name>.cu``, from ptxas's report of the build (``log``: that of
    another build, printed under ``name``; ``only``: a regex the kernels
    printed match)."""
    import re

    from segmentron_tpu_torch.ops.kernels import _target

    fn = None
    for ln in (log or _target(name).with_suffix(".log")).read_text().splitlines():
        if "Compiling entry function" in ln and only and not re.search(only, ln):
            fn = None
        elif "Compiling entry function" in ln:
            # the mangled name's kernel and its template arguments (Lb1E: int8;
            # the flash backward's Dv and, in f32, the Dk its sums are sized for)
            m = re.search(r"\d(probe_dot_(?:wgmma|mma_sync))(?:ILb([01])E)?", ln)
            sep = re.search(r"\d(sepconv_(?:wgmma_|resident_)?kernel)I(\w+?)EEv", ln)
            mb = re.search(r"\d((?:dq|dkv|flash)_(?:f32|bf16)_kernel)ILi(\d+)E(?:Li(\d+)E)?",
                           ln)
            ent = re.search(r"\d((?:stem_block1_wgmma|stem_block1|stem_wgmma|stem)_kernel)"
                            r"(?:I(\w+?)E)?", ln)
            if ent:  # the entry kernels: <f> f32, <13__nv_bfloat16> bf16
                fn = ent.group(1) + (f"<{'f32' if ent.group(2) == 'f' else 'bf16'}>"
                                     if ent.group(2) else "")
            elif sep:  # <T, DOT> of the older kernels, <DOT, N> of the wgmma kernel
                fn = f"{sep.group(1)}<{sep.group(2)}>"
            elif m:
                arg = m.group(2) and ("<int8>" if m.group(2) == "1" else "<bf16>")
                fn = m.group(1) + (arg or "")
            elif mb and mb.group(1).startswith("flash_"):  # <padded Dk, Dv of a block>
                fn = f"{mb.group(1)}<Dk padded to {mb.group(2)}, {mb.group(3)} Dv columns a block>"
            elif mb and "bf16" in mb.group(1):  # <padded Dk, Dv>
                fn = f"{mb.group(1)}<Dk padded to {mb.group(2)}, Dv {mb.group(3)}>"
            elif mb:
                fn = f"{mb.group(1)}<Dv {mb.group(2)}" + (
                    f", Dk <= {mb.group(3)}>" if mb.group(3) else ">")
            else:
                fn = ln
        elif fn and ("registers" in ln or "spill" in ln or "Performance" in ln):
            print(f"{card} ptxas {name} {fn}: {ln.split(':', 1)[-1].strip()}")
        elif "Performance" in ln or "warning" in ln:
            print(f"{card} ptxas {name}: {ln.strip()}")


def check_probe_dot(torch, probe_dot, card, dev, gen):
    """Each case in int8 and bf16, the probe's input distributions: the
    wrapper (which launches the kernel) against ``probe_dot_plain`` on the
    card, int8 bitwise, bf16 within one bf16 ulp plus the f32 rounding of
    K products (K 2^-24 sum|x w|: two f32 summation orders differ by up to
    that near zero, where a bf16 ulp is tiny); times of the kernel alone,
    the plain version and the library (``torch._int_mm`` + shift + cast,
    ``torch.matmul`` with a bf16 output)."""
    results = {}
    print_ptxas(card, "probe_dot")
    for m, k, n in PROBE_DOT_CASES:
        for dt in (torch.int8, torch.bfloat16):
            dname = dtype_name(dt)
            if dt == torch.int8:
                x = torch.randint(-127, 127, (m, k), generator=gen).to(dev, dt)
                w = torch.randint(-8, 8, (k, n), generator=gen).to(dev, dt)

                def library(x=x, w=w):
                    return (torch._int_mm(x, w) >> 7).to(torch.int8)
            else:
                x = torch.randn(m, k, generator=gen).to(dev, dt)
                w = (torch.randn(k, n, generator=gen) * 0.03).to(dev, dt)

                def library(x=x, w=w):
                    return torch.matmul(x, w)
            route = probe_dot.kernel_plan(x, w)
            mirror = probe_dot.plan(m, k, n, dt == torch.int8, x.data_ptr(), w.data_ptr(),
                                    torch.cuda.get_device_properties(0).multi_processor_count)
            print(f"{card} probe_dot {dname} ({m}, {k}, {n}) route: {route}")
            if any(mirror[key] != v for key, v in route.items()):
                fail(f"probe_dot: ops/probe_dot.py::plan {mirror} is not the kernel's {route}")
            ref = probe_dot.probe_dot_plain(x, w)
            before = probe_dot.probe_dot.launches
            got = probe_dot.probe_dot(x, w)
            torch.cuda.synchronize()
            if probe_dot.probe_dot.launches != before + 1:
                fail("probe_dot: the wrapper did not count its launch")
            if got.shape != ref.shape or got.dtype != dt:
                fail(f"probe_dot {dname} ({m}, {k}, {n}): {tuple(got.shape)} {got.dtype}")
            err = (got.float() - ref.float()).abs()
            max_err = err.max().item()
            if dt == torch.int8:
                shifted = (x.double() @ w.double()).div(128).floor()
                wrapped = ((shifted < -128) | (shifted > 127)).double()
                ok = torch.equal(got, ref)
                note = f"bitwise: {ok}; {wrapped.mean().item():.4f} of the outputs wrapped"
            else:
                r = ref.float()
                ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126))) - 7)
                sums = x.float().abs() @ w.float().abs()
                ok = bool((err <= ulp + k * 2.0 ** -24 * sums).all())
                beyond = int((err > ulp).sum())
                note = (f"within one bf16 ulp + K 2^-24 sum|x w|: {ok}; {beyond} of {err.numel()}"
                        f" beyond one ulp")
            out = torch.empty_like(got)
            kernel_ms = median_ms(torch, lambda: probe_dot._launch(x, w, out), hide_launch=True)
            plain_ms = median_ms(torch, lambda: probe_dot.probe_dot_plain(x, w), hide_launch=True)
            try:
                library_ms, lib = median_ms(torch, library, hide_launch=True), None
            except RuntimeError as e:  # cuBLASLt refuses some int8 shapes
                library_ms, lib = None, f"refused: {str(e).splitlines()[0][:120]}"
            if dt == torch.int8 and library_ms is not None:
                # the product alone, w as given and w column-major, the layout
                # cuBLASLt's int8 kernels want (the ceiling probe's int8 modes give it)
                wc = w.t().contiguous().t()
                row_ms = median_ms(torch, lambda: torch._int_mm(x, w), hide_launch=True)
                col_ms = median_ms(torch, lambda: torch._int_mm(x, wc), hide_launch=True)
                lib = (f"{library_ms:.4f} ms (the product alone: w row-major {row_ms:.4f} "
                       f"ms, column-major {col_ms:.4f} ms)")
            bound_ms, bound_by = probe_dot_bound(m, k, n, dname, x.element_size())
            print(f"{card} probe_dot {dname} ({m}, {k}) x ({k}, {n}): max|err| {max_err:.6g} "
                  f"[{note}]; kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{lib or f'{library_ms:.4f} ms'}, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                fail(f"probe_dot {dname} ({m}, {k}, {n}) disagrees with its plain version")
            results[f"{dname}_{m}x{k}x{n}"] = dict(
                max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, route=route["route"],
                producer=route["producer"])
            del x, w, ref, got, err, out
    return results


def probe_modes(torch, card, cfg, defaults, counts):
    """Every mode of the port's ceiling probe once, through the tool's own
    functions at full shapes, ``CP_TARGET`` and ``CP_ITERS`` reduced; the
    launch counters set to 0 before each mode and read after it. Returns
    ({mode: its JSON line}, {mode: launches})."""
    from segmentron_tpu_torch.tools import ceiling_probe

    zero_counts, read_counts = counts
    os.environ["CP_TARGET"] = PROBE_TARGET
    os.environ["CP_ITERS"] = PROBE_ITERS
    lines, launches = {}, {}
    for mode, run in ceiling_probe.MODES.items():
        zero_counts()
        t0 = time.perf_counter()
        lines[mode] = run()
        seconds = time.perf_counter() - t0
        launches[mode] = {k: v for k, v in read_counts().items() if v}
        print(f"{card} ceiling probe {mode}: {seconds:.1f} s, launches {launches[mode]}")
        if any(isinstance(v, str) and v.startswith("fail") for v in
               (lines[mode].get("r") or {}).values()):
            fail(f"ceiling probe {mode}: {lines[mode]}")
    want = sum(1 + ceiling_probe.chain_iters(2 * 8192 * c * c)
               for _, c in ceiling_probe.PALLAS_DOT_CASES)
    if launches["pallas_dot"].get("probe_dot", 0) != want:
        fail(f"pallas_dot launched probe_dot {launches['pallas_dot']} times, not {want} "
             f"(a warm launch and one a captured iteration, each case)")
    if launches["flagship"].get("fused_stem_block1", 0) < 1:
        fail(f"flagship launched no fused_stem_block1: {launches['flagship']}")
    reset_cfg(cfg, defaults)
    return lines, launches


def probe(torch, card):
    """Cycle shares of the fused separable conv's phases (see the
    module's docstring) at each main case in bf16: the wgmma kernel's, or
    the resident kernel's for a case that takes it."""
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
        counts = (ctypes.c_ulonglong * 11)()
        if lib.sepconv_probe(counts, 0) != 0:
            fail("sepconv_probe failed")
        head = f"{card} {case['fn']} bfloat16 {case['what']} int8_dot={case['int8']}"
        taps, waits, epilogue, total, blocks, tap_in, tap_sync = (float(c) for c in counts[4:])
        if blocks:
            kc = 128 if case["int8"] else 64
            n_steps = -(-case["shape"][3] // kc)
            print(f"{head}: wgmma kernel, {int(blocks)} items on persistent blocks, "
                  f"{total / blocks:.0f} cycles an item (consumer thread 0): taps "
                  f"{taps / total:.3f} ({taps / blocks / n_steps:.0f}"
                  f" cycles a {kc}-channel step, their products in flight; of which the wait for "
                  f"the input {tap_in / taps:.3f}, the closing barrier {tap_sync / taps:.3f}), "
                  f"waits on products and weights {waits / total:.3f}, epilogue "
                  f"{epilogue / total:.3f}")
            continue
        taps, phase2, epilogue, blocks = (float(c) for c in counts[:4])
        total = taps + phase2
        n_chunks = -(-case["shape"][3] // 32)
        print(f"{head}: resident kernel, {int(blocks)} blocks, {total / blocks:.0f} cycles a "
              f"block: taps {taps / total:.3f} ({taps / blocks / n_chunks:.0f} cycles a 32-channel "
              f"chunk), products {(phase2 - epilogue) / total:.3f}, epilogue "
              f"{epilogue / total:.3f}")
    return 0


# Probe builds of csrc/probe_dot.cu (--probe-dot): each leaves a phase out.
PROBE_DOT_BUILDS = {
    "full": (),
    "no stores": ("-DPROBE_DOT_NO_EPILOGUE",),
    "loads only": ("-DPROBE_DOT_NO_EPILOGUE", "-DPROBE_DOT_NO_MMA"),
    "x loads only": ("-DPROBE_DOT_NO_EPILOGUE", "-DPROBE_DOT_NO_MMA", "-DPROBE_DOT_NO_STRIPE"),
    "empty": ("-DPROBE_DOT_EMPTY",),
}
TRACE_PHASES = ("start", "init", "stripe", "full0", "mma0", "epi0", "full1", "mma1", "epi1",
                "end")


def probe_dot_breakdown(torch, card):
    """Where ``probe_dot``'s time goes at the probe's two shapes: the kernel
    and its probe builds (``PROBE_DOT_BUILDS``, wrong results, times only)
    timed in turns as ``check_probe_dot`` times it, beside the library; then
    one launch of the ``-DPROBE_DOT_TRACE`` build, whose blocks stamp the
    globaltimer at each phase: the median over blocks, us from the first
    block's start."""
    import ctypes

    import numpy as np

    from segmentron_tpu_torch.ops import kernels, probe_dot

    libs = probe_libs(card, "probe_dot", {**PROBE_DOT_BUILDS, "trace": ("-DPROBE_DOT_TRACE",)},
                      probe_dot._lib)
    libs["trace"].probe_dot_trace.argtypes = [ctypes.c_void_p]
    gen, dev = torch.Generator().manual_seed(0), torch.device("cuda")
    one = torch.zeros(1, device=dev)
    fill_ms = median_ms(torch, lambda: one.fill_(1.0), hide_launch=True)
    print(f"{card} probe_dot breakdown: a one-element fill_ takes {1e3 * fill_ms:.2f} us "
          f"between the same events (the floor of any launch)")
    for m, k, n in PROBE_DOT_CASES[:2]:
        for dt in (torch.int8, torch.bfloat16):
            if dt == torch.int8:
                x = torch.randint(-127, 127, (m, k), generator=gen).to(dev, dt)
                w = torch.randint(-8, 8, (k, n), generator=gen).to(dev, dt)
                wc = w.t().contiguous().t()  # column-major, as cuBLASLt's int8 path wants
                lib_fn = lambda: torch._int_mm(x, wc)  # noqa: E731
            else:
                x = torch.randn(m, k, generator=gen).to(dev, dt)
                w = (torch.randn(k, n, generator=gen) * 0.03).to(dev, dt)
                lib_fn = lambda: torch.matmul(x, w)  # noqa: E731
            out = torch.empty(m, n, dtype=dt, device=dev)
            times = {}
            for name in [*PROBE_DOT_BUILDS, *reversed(PROBE_DOT_BUILDS)]:
                kernels._loaded["probe_dot"] = libs[name]
                times.setdefault(name, []).append(
                    median_ms(torch, lambda: probe_dot._launch(x, w, out), hide_launch=True))
            lib_ms = median_ms(torch, lib_fn, hide_launch=True)
            print(f"{card} probe_dot {dtype_name(dt)} ({m}, {k}, {n}) "
                  f"{probe_dot.kernel_plan(x, w)['producer']}: " + ", ".join(
                      f"{name} {1e3 * statistics.mean(t):.2f} us" for name, t in times.items())
                  + f"; library {1e3 * lib_ms:.2f} us")
            kernels._loaded["probe_dot"] = libs["trace"]
            stamps = np.zeros((1024, len(TRACE_PHASES)), np.uint64)
            torch.cuda._sleep(2_000_000)
            probe_dot._launch(x, w, out)
            torch.cuda.synchronize()
            if libs["trace"].probe_dot_trace(stamps.ctypes.data) != 0:
                fail("probe_dot_trace failed")
            b = stamps[:probe_dot.kernel_plan(x, w)["grid"]].astype(np.int64)
            t0 = b[:, 0].min()
            phases = {name: float(np.median(b[b[:, i] >= t0, i] - t0)) / 1e3
                      for i, name in enumerate(TRACE_PHASES)
                      if (b[:, i] >= t0).any() and name != "start"}
            print(f"{card} probe_dot {dtype_name(dt)} ({m}, {k}, {n}) trace, median us: "
                  + ", ".join(f"{name} {v:.2f}" for name, v in phases.items()))
            stamps[:] = 0
    kernels._loaded.pop("probe_dot", None)
    return 0


def profile_thunk(torch, card, thunk, label, path, match=None):
    """Kernel time by name and the device's idle share of one call of
    ``thunk`` under ``torch.profiler`` (table written to ``OUT_DIR/path``);
    with ``match``, also the device time of the kernels whose name matches
    that regular expression."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        thunk()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(OUT_DIR, path), "w") as f:
        f.write(f"{card} {label}\n")
        f.write(table)
    device_kernels = sorted((e for e in averages if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in device_kernels)
    print(f"{card} profile of {label}: kernels {device_us / 1e3:.3f} ms of a "
          f"{window_us / 1e3:.3f} ms window (device idle share "
          f"{1 - device_us / window_us:.4f}), {sum(e.count for e in device_kernels)} "
          f"launches; top kernels by device time:")
    for e in device_kernels[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    matched = {} if match is None else dict(matched_ms=sum(
        e.self_device_time_total for e in device_kernels if re.search(match, e.key)) / 1e3)
    return dict(kernels_ms=device_us / 1e3, window_ms=window_us / 1e3, **matched,
                idle_share=1 - device_us / window_us,
                launches=sum(e.count for e in device_kernels),
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                     for e in device_kernels[:8]])


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
    from segmentron_tpu_torch.ops import attention, entrychain, probe_dot, sepconv
    from segmentron_tpu_torch.ops.kernels import BUILD_DIR, SOURCES, build

    if "segmentron_tpu" in sys.modules or "jax" in sys.modules:
        fail("JAX or the JAX package was imported")
    defaults = cfg.to_dict()
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
    if "--probe-dot" in sys.argv[1:]:
        return probe_dot_breakdown(torch, card)
    if "--flash-bwd" in sys.argv[1:]:
        return flash_bwd_only(torch, attention, card)
    if "--flash-fwd" in sys.argv[1:]:
        return flash_fwd_only(torch, attention, card)
    if "--sepconv" in sys.argv[1:]:
        return sepconv_only(torch, sepconv, card)
    if "--entry" in sys.argv[1:]:
        return entry_only(torch, entrychain, card)
    if any(a.startswith("--entry-probe") for a in sys.argv[1:]):
        return entry_probe(torch, entrychain, card)
    if "--sepconv-probe" in sys.argv[1:]:
        return sepconv_probe(torch, sepconv, card)
    if "--flash-fwd-probe" in sys.argv[1:]:
        return flash_fwd_probe(torch, attention, card)
    for arg in sys.argv[1:]:
        if arg.startswith("--flash-bwd-probe"):
            which = arg.partition("=")[2]
            return flash_bwd_probe(torch, attention, card, {
                "f32": ("float32",), "bf16": ("bfloat16",)}.get(which, ("float32", "bfloat16")))

    # ------------------------------------------------------------- 2. build
    train_only = "--train" in sys.argv[1:]
    eval_only_run = "--eval" in sys.argv[1:]
    t0 = time.perf_counter()
    per_source = build(["entrychain"] if train_only else ["entrychain", "attention"]
                       if eval_only_run else SOURCES)
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
        "flash_attention": attention.flash_attention,
        "flash_attention_split": attention.flash_attention_split,
        "flash_attention_bwd_dq": attention.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": attention.flash_attention_bwd_dkv,
        "probe_dot": probe_dot.probe_dot,
    }

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    if train_only:
        check_entry_plans(entrychain, card)
        results = flagship_train(torch, card, dev, defaults, (zero_counts, read_counts),
                                 functools.partial(profile_thunk, torch, card))
        print(json.dumps(results))
        print(f"flagship train only: {time.perf_counter() - t_start:.1f} s")
        return 0
    if eval_only_run:
        check_entry_plans(entrychain, card)
        check_fwd_plans(torch, attention, card)
        results = eval_only(torch, card, dev, defaults, (zero_counts, read_counts))
        print(json.dumps(results))
        print(f"eval only: {time.perf_counter() - t_start:.1f} s")
        return 0
    print_ptxas(card, "attention_bwd")
    check_bf16_sass(card)
    check_bwd_plans(attention, card)
    print_ptxas(card, "attention")
    check_fwd_sass(card)
    check_fwd_plans(torch, attention, card)
    check_sepconv_build(card)
    check_sepconv_plans(torch, sepconv, card)
    check_entry_build(card)
    check_entry_plans(entrychain, card)
    flash_bwd_results = check_flash_bwd_kernels(torch, attention, card, dev, gen)
    flash_results = check_flash_kernel(torch, attention, card, dev, gen)
    sep_results = check_sepconv_kernels(torch, sepconv, card, dev, gen)
    check_sepconv_wgmma_cases(sep_results)

    # --------------------------------------------------- 3b. ceiling probe
    probe_dot_results = check_probe_dot(torch, probe_dot, card, dev, gen)
    torch.cuda.empty_cache()
    probe_lines, probe_launches = probe_modes(torch, card, cfg, defaults,
                                              (zero_counts, read_counts))
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"sepconv": sep_results, "flash_attention": flash_results,
                          "flash_attention_bwd": flash_bwd_results,
                          "probe_dot": probe_dot_results, "ceiling_probe": probe_lines}))
        print(f"kernels only: {time.perf_counter() - t_start:.1f} s")
        return 0
    entry_kernels = check_entry_kernels(torch, entrychain, card, dev, gen)
    bad = entry_small_cases(torch, entrychain, card, dev, gen)
    if bad:
        fail(f"a bf16 entry kernel disagrees with its plain version at {bad}")
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
        # the fused entry routes and the plain-modules entry in turns, 3 rounds of 10
        fwd = {route: [] for route in routes}
        for rnd in range(3):
            for route in (routes if rnd % 2 == 0 else routes[::-1]):
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
    stem_fwd_ms = statistics.median(fwd["stem"])
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
          f"({1e3 / fwd_ms:.2f} img/s), the FUSED_STEM=\"stem\" route {stem_fwd_ms:.3f} ms "
          f"({1e3 / stem_fwd_ms:.2f} img/s), plain modules entry {plain_fwd_ms:.3f} ms "
          f"({1e3 / plain_fwd_ms:.2f} img/s) [medians of rounds {fwd['block1']}, "
          f"{fwd['stem']} and {fwd[False]}]; argmax agreement with the f32 plain "
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

    profile_call = functools.partial(profile_thunk, torch, card)

    def profile_forward(fn, label, image, path):
        with torch.inference_mode():
            return profile_call(lambda: fn(image), f"one forward, {label}, "
                                f"{cfg.TPU.COMPUTE_DTYPE}, 1x{SHAPE[1]}x{SHAPE[2]}", path)

    profile_forward(predict, "default path", image, "chip_smoke_profile.txt")
    profile_forward(predict8, "path B", image, "chip_smoke_profile_path_b.txt")
    set_routes(model8, routes_b_unfused)
    profile_forward(predict8, "path B unfused", image, "chip_smoke_profile_path_b_unfused.txt")
    del model, model8, predict, predict8, evaluator, evaluator_a, evaluator_b
    torch.cuda.empty_cache()

    # ----------------------------------------------------- 6. DANet, OCNet
    attn_models = attention_models(torch, card, dev, defaults, (zero_counts, read_counts),
                                   profile_forward, profile_call)

    # ------------------------------------------------- 7. DANet, OCNet train
    train = train_models(torch, card, dev, defaults, (zero_counts, read_counts), profile_call)

    # ------------------------------------------------- 8. flagship training
    # ------------------------------------- 9. evaluation and int8 serving
    # (on phase 8's Cityscapes tree and snapshots, before they are removed)
    flagship = flagship_train(
        torch, card, dev, defaults, (zero_counts, read_counts), profile_call,
        then=lambda tmp, snapshots: eval_phase(torch, card, dev, defaults,
                                               (zero_counts, read_counts), tmp, snapshots))
    serving = flagship.pop("then")

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
        # the DANet and OCNet-base runs of the Evaluator
        "flash_attention": attn_models["DANet"]["launches"] + attn_models["OCNet"]["launches"],
        # the DANet and OCNet-base f32 forwards of the kernel route (the f32 route only)
        "flash_attention_split": sum(attn_models[m]["f32_launches"]["flash_attention_split"]
                                     for m in ("DANet", "OCNet")),
        # one bf16 train step each of DANet and OCNet base
        **{name: sum(t["launches"][name] for t in train.values())
           for name in ATTENTION_BWD_REPLACES},
        # the ceiling probe's pallas_dot mode
        "probe_dot": probe_launches["pallas_dot"]["probe_dot"],
    }
    for name, count in launches.items():
        if count < 1:
            fail(f"{name} was launched no time on its path")
    measured = {name: (ENTRY_SOURCE, k["replaces"], k["bfloat16"])
                for name, k in entry_kernels.items()}
    measured.update({name: (SEPCONV_SOURCE, SEPCONV_REPLACES[name], sep_results[name]["bfloat16"])
                     for name in SEPCONV_REPLACES})
    flash_main = next(r["bfloat16"] for r in flash_results.values() if r["bfloat16"]["main"])
    measured["flash_attention"] = (ATTENTION_SOURCE, ATTENTION_REPLACES, flash_main)
    pieces_main = next(r["float32"]["pieces"] for r in flash_results.values()
                       if r["float32"]["main"])
    measured["flash_attention_split"] = (ATTENTION_SOURCE, ATTENTION_REPLACES, pieces_main)
    bwd_main = next(r["bfloat16"] for r in flash_bwd_results.values() if r["bfloat16"]["main"])
    for name, replaces in ATTENTION_BWD_REPLACES.items():
        measured[name] = (ATTENTION_BWD_SOURCE, replaces, bwd_main[name.rsplit("_", 1)[1]])
    measured["probe_dot"] = (PROBE_DOT_SOURCE, PROBE_DOT_REPLACES,
                             probe_dot_results["int8_8192x728x728"])
    line = {"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], max_abs_err=m["max_abs_err"], ms=m["ms"],
             plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
             library_ms=m.get("library_ms"),
             **{k: m[k] for k in ("kernel", "ms_launch_hidden", "host_us") if k in m})
        for name, (source, replaces, m) in measured.items()
    ]}
    summary = {"card": smi, "forward_ms": fwd_ms, "img_per_s": 1e3 / fwd_ms,
               "plain_entry_forward_ms": plain_fwd_ms, "stem_route_forward_ms": stem_fwd_ms,
               "path_forward_ms": path_ms,
               "argmax_agreement_f32": agree32, "argmax_agreement_bf16_vs_f32": agree16,
               "path_b_argmax_agreement_with_f32": {"f32": agree8_32, "bf16": agree8_16},
               "eval": {"default": main_default, "A": main_a, "B": main_b},
               "f32": {**{name: k["float32"] for name, k in entry_kernels.items()},
                       **{name: r["float32"] for name, r in sep_results.items()}},
               "flash_attention": flash_results, "flash_attention_bwd": flash_bwd_results,
               "attention_models": attn_models, "train": train, "flagship_train": flagship,
               "eval_and_int8_serving": serving,
               "probe_dot": probe_dot_results, "ceiling_probe": probe_lines,
               "seconds": time.perf_counter() - t_start}
    print(json.dumps(summary))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
