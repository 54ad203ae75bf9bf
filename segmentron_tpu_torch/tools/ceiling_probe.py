"""Compute-ceiling probe of the card, with true chained data dependence
(counterpart of ``tools/ceiling_probe.py``).

    CP_MODE=<mode> python3 -m segmentron_tpu_torch.tools.ceiling_probe

Environment, as the JAX tool reads it: ``CP_MODE`` (default ``matmul``),
``CP_TARGET`` (operations an iteration count is sized for, default 4e12),
``CP_ITERS`` (iterations of ``backbone``, 20, and ``flagship``, 30) and
``CP_CONV_SHAPES`` (``conv``'s shapes as ``NxHxWxC,...``). Each mode prints
one JSON line ``{"tool": "ceiling", "mode": ..., ...}`` with the JAX tool's
keys, and ``device``, the card's name.

Every chain threads the loop-carried value through the next iteration's
operand values (``a = f(a @ b)``, or ``w + mean(out) * 1e-30``), so no
iteration can be hoisted or skipped. On a card the whole chain is captured
as one CUDA graph and replayed between two CUDA events: no host work and no
synchronisation in the timed window. A warm iteration runs first (it builds
the kernels), and the scalar read back after each must be finite. On the
CPU, which only tests ask for, an eager loop is timed by the host clock.

Modes:
  matmul          bf16 n^3 chains, n in {2048, 4096, 8192}
  matmul_f32acc   the same with an f32 result cast back to bf16
  matmul_rect     bf16 products at the framework's conv-like shapes
  int8            s8 x s8 -> s32 n^3 chains (``torch._int_mm``, the second
                  operand column-major), low-byte feedback
  int8_rect       int8 products at the pointwise shapes
  pw_conv_vs_dot  a 1x1 conv against reshape + product at (1, 64, 128, 728)
  pallas_dot      the hand-written kernel ``ops/probe_dot.py`` at (8192, C), C in {728, 768}
  conv            3x3 bf16 conv chains
  backbone        ResNet-101, output stride 8, 1024x2048, bf16, input-chained
  flagship        DeepLabv3+ / Xception-65, output stride 16, 1024x2048, bf16, input-chained
  bnstats         BN train statistics, normalize, affine and ReLU against C
  dwred           dW reductions x^T dy with an f32 result
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import resolve_device

__all__ = [
    "MODES",
    "backbone_chain",
    "bnstats",
    "chain_iters",
    "conv_chain",
    "dwred",
    "f32_product",
    "flagship_chain",
    "int8_chain",
    "int8_rect",
    "main",
    "matmul_chain",
    "matmul_rect",
    "pallas_dot",
    "pw_conv_vs_dot",
    "time_chain",
]

T0 = time.time()
_BF16 = torch.bfloat16


def log(msg):
    print(f"[ceiling +{time.time() - T0:8.1f}s] {msg}", file=sys.stderr, flush=True)


def chain_iters(ops):
    """Iterations of a chain whose body does ``ops`` operations: enough
    for ``CP_TARGET`` operations in all, at least 2."""
    return max(2, int(float(os.environ.get("CP_TARGET", 4e12)) / ops))


def _emit(line, device):
    line["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(line), flush=True)
    return line


def _bf16(v):
    """``v`` rounded to bf16, as the JAX tool's ``jnp.bfloat16(v)``."""
    return float(torch.tensor(v, dtype=_BF16))


# the feedback's factor, jnp.bfloat16(1e-30) in the JAX tool
EPS = _bf16(1e-30)


def _scalar(t):
    return float(t.reshape(-1)[0].float())


def time_chain(body, carry, iters):
    """Seconds per iteration of ``carry = body(carry)``, ``iters`` times
    from ``carry``, after one warm iteration; both read-backs must be
    finite (the counterpart of the JAX tool's ``_time_chain``). On a card
    the chain is one CUDA graph, replayed once untimed, then timed."""
    cuda = carry.device.type == "cuda"
    if cuda:  # warm on a side stream before the capture, as graphs want
        side = torch.cuda.Stream(carry.device)
        side.wait_stream(torch.cuda.current_stream(carry.device))
        with torch.cuda.stream(side):
            warm = _scalar(body(carry))
        torch.cuda.current_stream(carry.device).wait_stream(side)
    else:
        warm = _scalar(body(carry))
    if not math.isfinite(warm):
        raise RuntimeError(f"warm iteration read back {warm}")
    if cuda:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = carry
            for _ in range(iters):
                out = body(out)
        graph.replay()  # the first replay also uploads the graph: untimed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = carry
        for _ in range(iters):
            out = body(out)
        sec = time.perf_counter() - t0
    value = _scalar(out)
    if not math.isfinite(value):
        raise RuntimeError(f"chain of {iters} iterations read back {value}")
    return sec / iters


def f32_product(device):
    """``(mm, how)``: ``mm(a, b)`` is the f32 result of a bf16 product on
    ``device``, by ``torch.mm(..., out_dtype=float32)`` where this torch
    has it there, else by a bf16 matmul cast to f32 (cuBLAS accumulates a
    bf16 product in f32 either way; only the output's rounding differs)."""
    t = torch.ones(2, 2, dtype=_BF16, device=device)
    try:
        torch.mm(t, t, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda a, b: torch.matmul(a, b).float()), "bf16 matmul cast to float32"
    return (lambda a, b: torch.mm(a, b, out_dtype=torch.float32)), "torch.mm out_dtype=float32"


def _col_major(t):
    """``t`` with its rows contiguous in memory down the columns: the
    layout of the second operand that cuBLASLt's int8 products want. With
    a row-major one ``torch._int_mm`` takes a slower path on an H100
    (``chip_smoke.py`` times both at the probe kernel's shape), which would
    measure that path, not the card."""
    return t.t().contiguous().t()


def _nchw(a, dtype, device):
    """An NHWC numpy array as an NCHW tensor in channels_last memory."""
    return torch.from_numpy(a).to(device, dtype).permute(0, 3, 1, 2)


def matmul_chain(f32acc: bool = False, sizes=(2048, 4096, 8192), device=None):
    dev = resolve_device(device)
    mm, how = f32_product(dev) if f32acc else (None, None)
    results = {}
    for n in sizes:
        rs = np.random.RandomState(0)
        a = torch.from_numpy(rs.randn(n, n)).to(dev, _BF16)
        b = torch.from_numpy(rs.randn(n, n)).to(dev, _BF16)
        scale = _bf16(1.0 / np.sqrt(n))

        if f32acc:
            def body(aa, b=b, scale=scale):
                return (mm(aa, b) * scale).to(_BF16)
        else:
            def body(aa, b=b, scale=scale):
                return torch.matmul(aa, b) * scale

        iters = chain_iters(2 * n**3)
        sec = time_chain(body, a, iters)
        tflops = 2 * n**3 / sec / 1e12
        results[n] = round(tflops, 1)
        log(f"n={n}: {sec*1e6:.0f} us/iter = {tflops:.1f} TFLOPs")
    line = {"tool": "ceiling", "mode": "matmul_f32acc" if f32acc else "matmul",
            "tflops": results}
    if f32acc:
        line["f32acc"] = how
    return _emit(line, dev)


def matmul_rect(cases=((73728, 4608, 512), (73728, 512, 512), (18432, 728, 728),
                       (18432, 6552, 728)), device=None):
    """Conv-shaped rectangular bf16 products (M, K, N): the 3x3x512x512
    conv's im2col equivalent and its pointwise counterpart, the flagship's
    middle-flow pointwise and its 3x3 as im2col."""
    dev = resolve_device(device)
    results = {}
    for m, k, n in cases:
        rs = np.random.RandomState(0)
        a = torch.from_numpy(rs.randn(m, k)).to(dev, _BF16)
        b = torch.from_numpy(rs.randn(k, n)).to(dev, _BF16)
        scale = _bf16(1.0 / np.sqrt(k))

        def body(bb, a=a, scale=scale):
            c = torch.matmul(a, bb) * scale
            # the mean keeps every element of c live; feeding it back
            # through the small operand keeps the chain's traffic small
            return bb + c.mean() * EPS

        flop = 2 * m * k * n
        iters = chain_iters(flop)
        sec = time_chain(body, b, iters)
        tflops = flop / sec / 1e12
        results[f"{m}x{k}x{n}"] = round(tflops, 1)
        log(f"{m}x{k}x{n}: {sec*1e6:.0f} us/iter = {tflops:.1f} TFLOPs")
    return _emit({"tool": "ceiling", "mode": "matmul_rect", "tflops": results}, dev)


def int8_rect(cases=((18432, 728, 728), (73728, 512, 512), (18432, 1536, 1536)), device=None):
    """int8 products (``torch._int_mm``, the carried operand column-major)
    at the framework's pointwise shapes."""
    dev = resolve_device(device)
    results = {}
    for m, k, n in cases:
        rs = np.random.RandomState(0)
        a = torch.from_numpy(rs.randint(-127, 127, (m, k))).to(dev, torch.int8)
        b = _col_major(torch.from_numpy(rs.randint(-127, 127, (k, n))).to(dev, torch.int8))

        def body(bb, a=a):  # the carried bb keeps b's layout
            c = torch._int_mm(a, bb)
            return bb + (c.sum() & 1).to(torch.int8)  # true dependence, all elements live

        flop = 2 * m * k * n
        iters = chain_iters(flop)
        sec = time_chain(body, b, iters)
        tops = flop / sec / 1e12
        results[f"{m}x{k}x{n}"] = round(tops, 1)
        log(f"{m}x{k}x{n}: {sec*1e6:.0f} us/iter = {tops:.1f} TOPS")
    return _emit({"tool": "ceiling", "mode": "int8_rect", "tops": results}, dev)


INT8_CONV = "not measured: PyTorch has no int8 convolution on CUDA"


def pw_conv_vs_dot(shape=(1, 64, 128, 728), device=None):
    """The same 1x1 conv as ``F.conv2d`` (channels_last) and as reshape +
    product, bf16 and int8 (``torch._int_mm`` with the weight
    column-major; the int8 conv has no PyTorch counterpart, and its entry
    says so)."""
    dev = resolve_device(device)
    results = {}
    n, h, w_, c = shape
    rs = np.random.RandomState(0)
    flop = 2 * n * h * w_ * c * c
    iters = chain_iters(flop)
    for dtype in (_BF16, torch.int8):
        name = "bfloat16" if dtype == _BF16 else "int8"
        if dtype == torch.int8:
            x = rs.randint(-127, 127, (n, h, w_, c))
            k = rs.randint(-127, 127, (1, 1, c, c))
        else:
            x = rs.randn(n, h, w_, c)
            k = rs.randn(1, 1, c, c) * 0.03
        x2 = torch.from_numpy(x.reshape(n * h * w_, c)).to(dev, dtype)
        k2 = torch.from_numpy(k.reshape(c, c)).to(dev, dtype)
        if dtype == torch.int8:
            def dot(kk, x2=x2):
                return kk + (torch._int_mm(x2, kk).sum() & 1).to(torch.int8)

            chains = {"dot": (dot, _col_major(k2))}
            results[f"{name}_conv"] = INT8_CONV
        else:
            xc = _nchw(x, dtype, dev)
            kc = torch.from_numpy(k).to(dev, dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)  # HWIO -> OIHW

            def conv(kk, xc=xc):
                return kk + F.conv2d(xc, kk).mean() * EPS

            def dot(kk, x2=x2):
                return kk + torch.matmul(x2, kk).mean() * EPS

            chains = {"conv": (conv, kc), "dot": (dot, k2)}
        for kind, (body, carry) in chains.items():
            sec = time_chain(body, carry, iters)
            eff = flop / sec / 1e12
            key = f"{name}_{kind}"
            results[key] = {"us": round(sec * 1e6, 1), "tops": round(eff, 1)}
            log(f"{key}: {sec*1e6:.1f} us = {eff:.1f} T")
    return _emit({"tool": "ceiling", "mode": "pw_conv_vs_dot", "r": results}, dev)


PALLAS_DOT_CASES = (("int8", 728), ("int8", 768), ("bf16", 728), ("bf16", 768))


def pallas_dot_inputs(dtype_name, m, c):
    """The JAX tool's inputs of one ``pallas_dot`` case, as numpy arrays."""
    rs = np.random.RandomState(0)
    if dtype_name == "int8":
        return (rs.randint(-127, 127, (m, c)).astype(np.int8),
                rs.randint(-8, 8, (c, c)).astype(np.int8))
    return rs.randn(m, c), rs.randn(c, c) * 0.03


def pallas_dot_body(x, dtype_name):
    """The chain's body around the kernel: ``w + (sum(o) & 1)`` in int8,
    ``w + mean(o) * 1e-30`` in bf16."""
    from ..ops.probe_dot import probe_dot

    if dtype_name == "int8":
        def body(ww):
            # one pass: the int64 sum's parity is the int32 sum's (|sum| < 2^31 here)
            return ww + (probe_dot(x, ww).sum(dtype=torch.int64) & 1).to(torch.int8)
    else:
        def body(ww):
            return ww + probe_dot(x, ww).mean() * EPS
    return body


def pallas_dot(m=8192, cases=PALLAS_DOT_CASES, device=None):
    """The hand-written kernel (``ops/probe_dot.py``) at the middle-flow
    pointwise shape: can it reach the tensor cores' int8 and bf16 rates
    at M = 8192, K = N = 728 (and the 768-padded variant)? A case that
    fails is recorded as ``"fail: <exception>"``, as the JAX tool does."""
    dev = resolve_device(device)
    results = {}
    for dtype_name, c in cases:
        dtype = torch.int8 if dtype_name == "int8" else _BF16
        x, w = (torch.from_numpy(a).to(dev, dtype) for a in pallas_dot_inputs(dtype_name, m, c))
        flop = 2 * m * c * c
        iters = chain_iters(flop)
        try:
            sec = time_chain(pallas_dot_body(x, dtype_name), w, iters)
            eff = flop / sec / 1e12
            results[f"{dtype_name}_{c}"] = {"us": round(sec * 1e6, 1), "tops": round(eff, 1)}
            log(f"{dtype_name} c={c}: {sec*1e6:.1f} us = {eff:.1f} T")
        except Exception as e:
            results[f"{dtype_name}_{c}"] = f"fail: {type(e).__name__}"
            log(f"{dtype_name} c={c}: FAILED {e}")
    return _emit({"tool": "ceiling", "mode": "pallas_dot", "r": results}, dev)


def int8_chain(sizes=(2048, 4096, 8192), device=None):
    dev = resolve_device(device)
    results = {}
    for n in sizes:
        rs = np.random.RandomState(0)
        a = torch.from_numpy(rs.randint(-127, 127, (n, n))).to(dev, torch.int8)
        b = _col_major(torch.from_numpy(rs.randint(-127, 127, (n, n))).to(dev, torch.int8))

        def body(aa, b=b):
            # low-byte feedback: true dependence, bounded values
            return (torch._int_mm(aa, b) & 127).to(torch.int8)

        iters = chain_iters(2 * n**3)
        sec = time_chain(body, a, iters)
        tops = 2 * n**3 / sec / 1e12
        results[n] = round(tops, 1)
        log(f"n={n}: {sec*1e6:.0f} us/iter = {tops:.1f} TOPS")
    return _emit({"tool": "ceiling", "mode": "int8", "tops": results}, dev)


CONV_SHAPES = (
    (8, 96, 96, 512),    # W not a multiple of 128
    (1, 128, 256, 512),  # ResNet-like output-stride-8 geometry
    (8, 128, 128, 512),  # batch and aligned W
    (1, 64, 128, 728),   # middle-flow geometry, dense
)


def conv_shapes():
    """``CP_CONV_SHAPES`` (``NxHxWxC,...``) or the default four."""
    spec = os.environ.get("CP_CONV_SHAPES")
    if not spec:
        return CONV_SHAPES
    return tuple(tuple(int(v) for v in s.split("x")) for s in spec.split(","))


def conv_chain(shapes=None, device=None):
    """3x3 bf16 conv chains (channels_last) across shapes given as NHWC."""
    dev = resolve_device(device)
    results = {}
    for shape in shapes or conv_shapes():
        n, h, w_, c = shape
        rs = np.random.RandomState(0)
        x = _nchw(rs.randn(*shape), _BF16, dev)
        w = torch.from_numpy(rs.randn(3, 3, c, c) * 0.02).to(dev, _BF16).permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        scale = _bf16(1.0 / 68.0)

        def body(xx, w=w, scale=scale):
            return F.conv2d(xx, w, padding=1) * scale

        flop = 2 * n * h * w_ * c * c * 9
        iters = chain_iters(flop)
        sec = time_chain(body, x, iters)
        tflops = flop / sec / 1e12
        results["x".join(map(str, shape))] = round(tflops, 1)
        log(f"conv3x3 @{shape}: {sec*1e3:.2f} ms/iter = {tflops:.1f} TFLOPs")
    return _emit({"tool": "ceiling", "mode": "conv", "tflops": results}, dev)


def _bf16_model(model):
    from ..engine.steps import _cast_params

    _cast_params(model, _BF16)
    return model


def _model_line(mode, sec, h, w, device):
    return _emit({"tool": "ceiling", "mode": mode, "h": h, "w": w,
                  "ms_per_iter": round(sec * 1e3, 2), "img_per_s": round(1.0 / sec, 2)}, device)


def backbone_chain(h=1024, w=2048, iters=None, device=None):
    """ResNet-101 at output stride 8 on an (1, 3, h, w) bf16 input, eval
    forward with seeded random bf16 weights, chained through the input by
    ``c4.mean() * EPS`` (a real dependence that bf16 rounds away)."""
    from ..config import cfg
    from ..models.backbones import get_segmentation_backbone
    from ..models.segbase import init_weights
    from ..modules import norm_from_cfg

    dev = resolve_device(device)
    cfg.defrost()
    cfg.MODEL.BACKBONE = "resnet101"
    cfg.MODEL.OUTPUT_STRIDE = 8
    cfg.TRAIN.SYNC_BATCH_NORM = False
    module = get_segmentation_backbone("resnet101", norm_from_cfg(cfg))
    init_weights(module, torch.Generator().manual_seed(0))
    module = _bf16_model(module.eval().to(dev, memory_format=torch.channels_last))
    x = torch.zeros((1, 3, h, w), dtype=_BF16, device=dev).contiguous(
        memory_format=torch.channels_last)

    @torch.inference_mode()
    def body(xx):
        return xx + module(xx)[-1].mean() * EPS

    iters = iters or int(os.environ.get("CP_ITERS", 20))
    log("backbone chain")
    sec = time_chain(body, x, iters)
    log(f"backbone chain: {sec*1e3:.2f} ms/iter")
    return _model_line("backbone", sec, h, w, dev)


def flagship_chain(h=1024, w=2048, iters=None, device=None):
    """DeepLabv3+ / Xception-65 at output stride 16 (the default route:
    the fused stem + block1 kernel), eval forward with seeded random bf16
    weights on an (1, h, w, 3) bf16 input, chained through the input by
    ``out[0].mean() * EPS``."""
    from ..config import cfg
    from ..models import get_segmentation_model

    dev = resolve_device(device)
    cfg.defrost()
    cfg.DATASET.NAME = "cityscapes"
    cfg.MODEL.MODEL_NAME = "DeepLabV3_Plus"
    cfg.MODEL.BACKBONE = "xception65"
    cfg.MODEL.OUTPUT_STRIDE = 16
    cfg.SOLVER.AUX = False
    cfg.TRAIN.SYNC_BATCH_NORM = False
    model = _bf16_model(get_segmentation_model(dev, torch.Generator().manual_seed(0)))
    x = torch.zeros((1, h, w, 3), dtype=_BF16, device=dev)

    @torch.inference_mode()
    def body(xx):
        return xx + model(xx)[0].mean() * EPS

    iters = iters or int(os.environ.get("CP_ITERS", 30))
    log("flagship chain")
    sec = time_chain(body, x, iters)
    log(f"flagship chain: {sec*1e3:.2f} ms/iter")
    return _model_line("flagship", sec, h, w, dev)


def bnstats(channels=(32, 64, 128, 256), n=8, h=256, wc=32768, iters=50, device=None):
    """BN in training (batch statistics in f32, normalize, affine) and
    ReLU with bf16 out, at a constant element count (n, h, wc / C, C), as
    the port's ``BatchNorm2d`` computes it (``torch.native_batch_norm``)."""
    dev = resolve_device(device)
    results = {}
    for c in channels:
        w_ = wc // c
        rs = np.random.RandomState(0)
        x = _nchw(rs.randn(n, h, w_, c), _BF16, dev)
        g = torch.from_numpy(rs.rand(c) + 0.5).to(dev, torch.float32)
        b = torch.from_numpy(rs.randn(c)).to(dev, torch.float32)

        def body(xx, g=g, b=b):
            y = torch.native_batch_norm(xx, g, b, None, None, True, 0.0, 1e-5)[0].relu()
            return xx + y.mean() * EPS

        sec = time_chain(body, x, iters)
        results[c] = round(sec * 1e3, 3)
        log(f"C={c} (shape {n}x{h}x{w_}x{c}): {sec*1e3:.3f} ms/iter")
    return _emit({"tool": "ceiling", "mode": "bnstats", "ms": results}, dev)


def dwred(cases=((294912, 64, 128), (147456, 128, 128), (294912, 128, 128), (294912, 32, 64)),
          iters=100, device=None):
    """dW reductions x^T dy (K spatial positions, Cin, Cout) with an f32
    result, at the block1 pointwise, W-folded, 2x control and stem-like
    widths."""
    dev = resolve_device(device)
    mm, how = f32_product(dev)
    results = {}
    for k, ci, co in cases:
        rs = np.random.RandomState(0)
        xa = torch.from_numpy(rs.randn(k, ci)).to(dev, _BF16)
        dy = torch.from_numpy(rs.randn(k, co)).to(dev, _BF16)

        def body(dyy, xa=xa):
            return dyy + mm(xa.t(), dyy).mean() * EPS

        flop = 2 * k * ci * co
        sec = time_chain(body, dy, iters)
        eff = flop / sec / 1e12
        results[f"{k}x{ci}x{co}"] = {"us": round(sec * 1e6, 1), "tflops": round(eff, 1)}
        log(f"K={k} Cin={ci} Cout={co}: {sec*1e6:.1f} us = {eff:.1f} TF")
    return _emit({"tool": "ceiling", "mode": "dwred", "r": results, "f32acc": how}, dev)


MODES = {
    "matmul": lambda: matmul_chain(False),
    "matmul_f32acc": lambda: matmul_chain(True),
    "matmul_rect": matmul_rect,
    "int8": int8_chain,
    "int8_rect": int8_rect,
    "pw_conv_vs_dot": pw_conv_vs_dot,
    "pallas_dot": pallas_dot,
    "conv": conv_chain,
    "backbone": backbone_chain,
    "flagship": flagship_chain,
    "bnstats": bnstats,
    "dwred": dwred,
}


def main():
    mode = os.environ.get("CP_MODE", "matmul")
    if mode not in MODES:
        raise SystemExit(f"unknown CP_MODE={mode}")
    MODES[mode]()


if __name__ == "__main__":
    main()
