#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``segmentron_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA source under ``segmentron_tpu_torch/csrc`` with
   ``nvcc``, all started together;
3. kernels: each hand-written kernel against its plain PyTorch version
   at the main path's shape (1, 1024, 2048, 3), in f32 (TF32 off) and
   bf16, with the stated tolerances; times by CUDA events (median of 20
   after warm-up) beside the bound the card sets for the same work;
4. model: DeepLabv3+ / Xception-65 (OS16, 16 middle blocks, 19 classes)
   from the flagship YAML with random weights from a seed, in f32 (TF32
   off): the fused entry routes ("block1", "stem") against the plain
   modules, logits on a small input and argmax at full width (>= 0.995);
5. main path, bf16: the ``Evaluator`` over 4 synthetic 1024x2048 uint8
   images with every kernel launch counter read around it; the forward
   time; each entry route's argmax against the f32 reference, no
   further from it than the plain modules' own bf16 route; the
   ``TPU.FUSED_STEM="stem"`` route's launches; a profiler breakdown of
   one forward (written to ``chiprun_out/``).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
SHAPE = (1, 1024, 2048, 3)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense; f32 on CUDA cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
OUT_DIR = "chiprun_out"


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


def bound(n, h, w, block1, dtype_name, itemsize):
    """(ms, 'bytes' | 'operations'): the least time the card could take,
    each input read once and each output written once."""
    macs, cout, stride = entry_work(h, w, block1)
    nbytes = (n * h * w * 3 + n * (h // stride) * (w // stride) * cout) * itemsize
    t_ops = 2 * n * macs / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from segmentron_tpu_torch.config import cfg
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import Evaluator, make_predict_fn
    from segmentron_tpu_torch.models import get_segmentation_model
    from segmentron_tpu_torch.ops import entrychain
    from segmentron_tpu_torch.ops.kernels import SOURCES, build

    if "segmentron_tpu" in sys.modules:
        fail("the JAX package was imported")
    os.makedirs(OUT_DIR, exist_ok=True)

    # ------------------------------------------------------------ 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {smi}")

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    per_source = build(SOURCES)
    print(f"{card} build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")

    # ----------------------------------------------------------- 3. kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
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
            dname = str(dt).split(".")[-1]
            # time the kernel alone (weights packed once, no counter)
            entry, groups = k["launch"]
            packed = entrychain.pack_weights(x, *groups)
            out = torch.empty_like(got)
            kernel_ms = median_ms(torch, lambda: entrychain._launch(
                entry, k["block1"], x, packed, out))
            plain_ms = median_ms(torch, lambda: k["plain"](x))
            bound_ms, bound_by = bound(n, h, w, k["block1"], dname, x.element_size())
            print(f"{card} {name} {dname} {tuple(x.shape)}: max|err| {max_err:.6g} "
                  f"(max|ref| {max_ref:.6g}), mean|err| {mean_err:.6g} (mean|ref| "
                  f"{mean_ref:.6g}) [{rule}: {'ok' if ok else 'FAIL'}]; kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})")
            if not ok:
                fail(f"{name} {dname} disagrees with its plain version")
            k[dname] = dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    del x32, x, ref, got, err, out

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
    print(f"model: DeepLabV3_Plus/xception65, OS{cfg.MODEL.OUTPUT_STRIDE}, "
          f"{bb.middle_blocks} middle blocks, nclass {model.nclass}, "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    small = torch.randn(1, 64, 128, 3, generator=gen).to(dev)
    with torch.inference_mode():
        fused = model(small)[0]
        bb.fused_stem = False
        plain = model(small)[0]
        bb.fused_stem = cfg.TPU.FUSED_STEM
    scale = max(1.0, plain.abs().max().item())
    small_err = (fused - plain).abs().max().item()
    print(f"{card} f32 (1, 64, 128, 3): fused entry vs plain modules max|err| "
          f"{small_err:.6g} (scale {scale:.6g}) [<= 1e-3 scale]")
    if not (torch.isfinite(fused).all() and small_err <= 1e-3 * scale):
        fail("fused entry disagrees with the plain modules in f32")

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

    def agreement(a, b):
        return (a == b).float().mean().item()

    ref = route_preds(make_predict_fn(model, "float32", dev))
    agree32 = {r: agreement(ref[r], ref[False]) for r in routes[:2]}
    print(f"{card} f32 {SHAPE}: argmax agreement of the fused routes with the plain "
          f"modules {agree32} [>= 0.995]")
    if min(agree32.values()) < 0.995:
        fail("fused entry: argmax agreement with the plain modules below 0.995 in f32")
    torch.backends.cudnn.allow_tf32 = True  # the model's own default from here on

    # --------------------------------------------------------- 5. main path
    evaluator = Evaluator(model, dataset)  # casts the weights to bf16
    for k in kernels.values():
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    pix_acc, miou, _ = evaluator.eval()
    eval_s = time.perf_counter() - t0
    main_launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    cm = evaluator.metric.confusion_matrix
    labelled = sum(int(((m >= 0) & (m < model.nclass)).sum())
                   for m in (dataset[i][1] for i in range(len(dataset))))
    print(f"{card} eval: {len(dataset)} images {SHAPE[1]}x{SHAPE[2]} "
          f"{cfg.TPU.COMPUTE_DTYPE} in {eval_s:.3f} s: pixAcc {pix_acc:.6f}, mIoU "
          f"{miou:.6f}, confusion-matrix total {cm.sum()} of {labelled} labelled "
          f"pixels; launches {main_launches}")
    if cm.sum() != labelled:
        fail("confusion-matrix total differs from the labelled pixel count")
    if main_launches["fused_stem_block1"] != len(dataset):
        fail(f"fused_stem_block1 launched {main_launches['fused_stem_block1']} times "
             f"for {len(dataset)} images")

    predict = evaluator.predict_fn
    with torch.inference_mode():
        logits = predict(image)
        if logits.shape != (1, SHAPE[1], SHAPE[2], model.nclass):
            fail(f"logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            fail("non-finite logits")
        # the fused and the plain-modules entry in turns, 3 rounds of 10
        fwd = {"block1": [], False: []}
        for rnd in range(3):
            for route in (("block1", False) if rnd % 2 == 0 else (False, "block1")):
                bb.fused_stem = route
                fwd[route].append(median_ms(torch, lambda: predict(image), n=10, warmup=2))
        bb.fused_stem = cfg.TPU.FUSED_STEM
    fwd_ms, plain_fwd_ms = statistics.median(fwd["block1"]), statistics.median(fwd[False])
    for k in kernels.values():
        k["wrapper"].launches = 0
    half = route_preds(predict)  # one forward per route: the stem route's own path
    route_launches = {name: k["wrapper"].launches for name, k in kernels.items()}
    # The random model's argmax is itself sensitive to bf16 rounding, so
    # each bf16 route is held to the f32 reference no worse than the
    # plain modules' own bf16 route is.
    agree16 = {r: agreement(half[r], ref[False]) for r in routes}
    print(f"{card} forward (1, {SHAPE[1]}, {SHAPE[2]}, 3) uint8 -> f32 logits, "
          f"{cfg.TPU.COMPUTE_DTYPE}: fused entry {fwd_ms:.3f} ms "
          f"({1e3 / fwd_ms:.2f} img/s), plain modules entry {plain_fwd_ms:.3f} ms "
          f"({1e3 / plain_fwd_ms:.2f} img/s) [medians of rounds {fwd['block1']} and "
          f"{fwd[False]}]; argmax agreement with the f32 plain "
          f"reference per bf16 route {agree16}; bf16 fused vs bf16 plain: block1 "
          f"{agreement(half['block1'], half[False]):.6f}, stem "
          f"{agreement(half['stem'], half[False]):.6f}; launches {route_launches}")
    if min(agree16["block1"], agree16["stem"]) < agree16[False] - 0.005:
        fail("a fused route's bf16 argmax is further from the f32 reference than "
             "the plain modules' by more than 0.005")
    if route_launches != {"fused_stem_block1": 1, "fused_stem": 1}:
        fail(f"route launches {route_launches}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(image)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{card} one forward, {cfg.TPU.COMPUTE_DTYPE}, 1x{SHAPE[1]}x{SHAPE[2]}\n")
        f.write(table)
    device_kernels = sorted((e for e in averages if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in device_kernels)
    print(f"{card} profile of one forward: kernels {device_us / 1e3:.3f} ms of a "
          f"{window_us / 1e3:.3f} ms window (device idle share "
          f"{1 - device_us / window_us:.4f}); top kernels by device time:")
    for e in device_kernels[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")

    # ------------------------------------------------------------ results
    # fused_stem lies on the FUSED_STEM="stem" route: its count is that route's
    launches = {"fused_stem_block1": main_launches["fused_stem_block1"],
                "fused_stem": route_launches["fused_stem"]}
    line = {"kernels": [
        dict(name=name, route="cuda", source="segmentron_tpu_torch/csrc/entrychain.cu",
             replaces=k["replaces"], launches=launches[name],
             max_abs_err=k["bfloat16"]["max_abs_err"], ms=k["bfloat16"]["ms"],
             plain_ms=k["bfloat16"]["plain_ms"], bound_ms=k["bfloat16"]["bound_ms"],
             bound_by=k["bfloat16"]["bound_by"], library_ms=None)
        for name, k in kernels.items()
    ]}
    not_ported = {"kernels_not_ported": [
        "segmentron_tpu/ops/attention.py:44 (_flash_kernel)",
        "segmentron_tpu/ops/attention.py:161 (_flash_bwd_dq_kernel), :185 (_flash_bwd_dkv_kernel)",
        "segmentron_tpu/ops/sepconv.py:282 (_kernel_v3)",
        "segmentron_tpu/ops/sepconv.py:396 (_kernel_v3_skip)",
        "segmentron_tpu/ops/sepconv.py:174 (_kernel_v2)",
        "segmentron_tpu/ops/sepconv.py:86 (_kernel)",
        "tools/ceiling_probe.py:298 (kern)",
    ]}
    summary = {"card": smi, "forward_ms": fwd_ms, "img_per_s": 1e3 / fwd_ms,
               "plain_entry_forward_ms": plain_fwd_ms, "argmax_agreement_f32": agree32,
               "argmax_agreement_bf16_vs_f32": {str(k): v for k, v in agree16.items()},
               "pix_acc": pix_acc, "miou": miou,
               "f32": {name: k["float32"] for name, k in kernels.items()}}
    print(json.dumps(summary))
    print(json.dumps(not_ported))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
