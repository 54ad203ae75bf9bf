"""The port's ceiling probe (segmentron_tpu_torch/tools/ceiling_probe.py)
and its kernel's plain version (segmentron_tpu_torch/ops/probe_dot.py)
against the JAX tool, on the CPU.

The JAX tool's ``pallas_dot`` builds its Pallas kernel ``kern`` inside the
function; a recorder standing in for ``pallas_call`` collects each ``kern``
(and makes the TPU call fail, which the tool records as "fail"), and the
tests run the recorded kernels in interpret mode. Tolerances: int8 bitwise
(the product is exact, and the cast wraps); bf16 one bf16 ulp of the value
plus the f32 rounding that two summation orders of K products may differ
by (K * 2^-24 * sum |x w|), which only outputs near zero ever need.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from segmentron_tpu_torch.ops import probe_dot as port_dot
from segmentron_tpu_torch.tools import ceiling_probe as port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 256  # rows: two of the interpret grid's 128-row blocks
# the JAX tool's JSON keys by mode (tools/ceiling_probe.py), besides tool and mode
JAX_KEYS = {
    "matmul": {"tflops"}, "matmul_f32acc": {"tflops"}, "matmul_rect": {"tflops"},
    "int8": {"tops"}, "int8_rect": {"tops"}, "pw_conv_vs_dot": {"r"}, "pallas_dot": {"r"},
    "conv": {"tflops"}, "bnstats": {"ms"}, "dwred": {"r"},
}


@pytest.fixture(scope="module")
def kerns():
    """{(dtype name, C): the JAX tool's ``kern``}, recorded from its
    ``pallas_dot()``."""
    cache_dir = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    spec = importlib.util.spec_from_file_location(
        "jax_ceiling_probe", os.path.join(REPO, "tools", "ceiling_probe.py"))
    tool = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(tool)
    finally:  # the tool sets both at import
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    recorded = {}

    def recorder(kern, **kw):
        shape = kw["out_shape"]
        name = "int8" if shape.dtype == jnp.int8 else "bf16"
        recorded[(name, shape.shape[1])] = kern

        def call(*args):
            raise RuntimeError("recorded, not run")
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recorder)
        tool.pallas_dot()
    assert sorted(recorded) == sorted(port.PALLAS_DOT_CASES)
    return recorded


def _interpret(kern, x, w):
    """The recorded Pallas kernel in interpret mode over 128-row blocks."""
    m, c = x.shape
    call = pl.pallas_call(
        kern, grid=(m // 128,),
        in_specs=[pl.BlockSpec((128, c), lambda i: (i, 0)),
                  pl.BlockSpec((c, c), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((128, c), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, c), x.dtype), interpret=True)
    return np.asarray(call(x, w))


def _inputs(name, c, m=M):
    """(torch x, torch w, jnp x, jnp w) from the JAX tool's distributions."""
    x, w = port.pallas_dot_inputs(name, m, c)
    if name == "int8":
        return (torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x, jnp.int8),
                jnp.asarray(w, jnp.int8))
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    return (xt, wt, jnp.asarray(xt.float().numpy(), jnp.bfloat16),
            jnp.asarray(wt.float().numpy(), jnp.bfloat16))


def _assert_bf16_close(got, want, x, w):
    """Within one bf16 ulp of ``want`` plus the f32 summation bound."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    mag = np.abs(x.float().numpy()).astype(np.float64) @ np.abs(w.float().numpy())
    bar = ulp + x.shape[1] * 2.0 ** -24 * mag
    assert np.all(np.abs(got - want) <= bar)
    assert np.mean(np.abs(got - want) <= ulp) > 0.999


@pytest.mark.parametrize("name,c", port.PALLAS_DOT_CASES)
def test_plain_matches_pallas_kern(kerns, name, c):
    xt, wt, xj, wj = _inputs(name, c)
    want = _interpret(kerns[(name, c)], xj, wj)
    got = port_dot.probe_dot_plain(xt, wt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (M, c)
    if name == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
        shifted = (xt.numpy().astype(np.int64) @ wt.numpy().astype(np.int64)) >> 7
        wrapped = np.mean((shifted < -128) | (shifted > 127))
        assert wrapped >= 0.05, wrapped  # the cast wraps: saturation would differ here
    else:
        _assert_bf16_close(got.float().numpy(), want.astype(np.float32), xt, wt)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_probe_dot_on_cpu_is_plain(dtype):
    rng = np.random.RandomState(1)
    x, w = rng.randint(-127, 127, (300, 40)), rng.randint(-127, 127, (40, 72))
    x, w = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    before = port_dot.probe_dot.launches
    got = port_dot.probe_dot(x, w)
    assert port_dot.probe_dot.launches == before == 0
    assert torch.equal(got, port_dot.probe_dot_plain(x, w))


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_chain_matches_jax_body(kerns, name):
    """Two iterations of the port's ``pallas_dot`` body against the JAX
    body's feedback (``ww + (sum(o) & 1)``, ``ww + mean(o) * 1e-30``) fed
    by the interpreted kernel."""
    c = 728
    xt, wt, xj, wj = _inputs(name, c)
    body = port.pallas_dot_body(xt, name)
    got, want = wt, wj
    for _ in range(2):
        got = body(got)
        o = jnp.asarray(_interpret(kerns[(name, c)], xj, want))
        if name == "int8":
            want = want + (o.astype(jnp.int32).sum() & 1).astype(jnp.int8)
        else:
            want = want + o.mean().astype(jnp.bfloat16) * jnp.asarray(1e-30, jnp.bfloat16)
    assert got.dtype == wt.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


FAST_MODES = {
    "matmul": lambda: port.matmul_chain(False, sizes=(32,), device="cpu"),
    "matmul_f32acc": lambda: port.matmul_chain(True, sizes=(32,), device="cpu"),
    "matmul_rect": lambda: port.matmul_rect(cases=((64, 40, 24),), device="cpu"),
    "int8": lambda: port.int8_chain(sizes=(32,), device="cpu"),
    "int8_rect": lambda: port.int8_rect(cases=((64, 40, 24),), device="cpu"),
    "pw_conv_vs_dot": lambda: port.pw_conv_vs_dot(shape=(1, 4, 8, 24), device="cpu"),
    "pallas_dot": lambda: port.pallas_dot(m=64, cases=(("int8", 40), ("bf16", 40)),
                                          device="cpu"),
    "conv": lambda: port.conv_chain(shapes=((1, 8, 8, 16),), device="cpu"),
    "bnstats": lambda: port.bnstats(channels=(8, 16), n=2, h=4, wc=64, iters=3,
                                    device="cpu"),
    "dwred": lambda: port.dwred(cases=((128, 8, 16),), iters=3, device="cpu"),
}


@pytest.mark.parametrize("mode", sorted(FAST_MODES))
def test_mode_prints_jax_keys(mode, capsys, monkeypatch):
    monkeypatch.setenv("CP_TARGET", "1e6")
    returned = FAST_MODES[mode]()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(returned))
    extra = {"device"} | ({"f32acc"} if mode in ("matmul_f32acc", "dwred") else set())
    assert set(line) == {"tool", "mode"} | JAX_KEYS[mode] | extra
    assert (line["tool"], line["mode"], line["device"]) == ("ceiling", mode, "cpu")
    results = line[next(iter(JAX_KEYS[mode]))]
    assert results and not any(isinstance(v, str) and v.startswith("fail") for v in
                               results.values())
    if mode == "pw_conv_vs_dot":
        assert results["int8_conv"] == port.INT8_CONV
        assert set(results) == {"bfloat16_conv", "bfloat16_dot", "int8_conv", "int8_dot"}


def test_main_env(monkeypatch):
    monkeypatch.setenv("CP_CONV_SHAPES", "1x256x512x48,1x128x256x96")
    assert port.conv_shapes() == ((1, 256, 512, 48), (1, 128, 256, 96))
    monkeypatch.setenv("CP_MODE", "no_such_mode")
    with pytest.raises(SystemExit, match="unknown CP_MODE=no_such_mode"):
        port.main()
    assert set(port.MODES) == set(JAX_KEYS) | {"backbone", "flagship"}
