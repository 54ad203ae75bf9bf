"""The port's fused entry chain (segmentron_tpu_torch/ops/entrychain.py)
against the JAX package's oracles, on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version, so
these tests hold that version (the one chip_smoke.py holds the CUDA
kernels against on the card) to ``fused_stem_ref`` /
``fused_stem_block1_ref`` at the bar of tests/test_entrychain.py, and
once to the Pallas kernel itself in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.ops import entrychain as jec
from segmentron_tpu_torch.ops import entrychain as tec

torch.set_num_threads(2)

TOL = 2e-5  # tests/test_entrychain.py: exact up to f32 reassociation


def _stem_params(rng):
    return (
        (rng.randn(3, 3, 3, 32) * 0.2).astype(np.float32),
        (rng.rand(32) + 0.5).astype(np.float32),
        (rng.randn(32) * 0.3).astype(np.float32),
        (rng.randn(3, 3, 32, 64) * 0.1).astype(np.float32),
        (rng.rand(64) + 0.5).astype(np.float32),
        (rng.randn(64) * 0.3).astype(np.float32),
    )


def _block1_params(rng):
    def sep(cin, cout):
        return (
            (rng.randn(3, 3, 1, cin) * 0.2).astype(np.float32),
            (rng.rand(cin) + 0.5).astype(np.float32),
            (rng.randn(cin) * 0.3).astype(np.float32),
            (rng.randn(1, 1, cin, cout) * 0.1).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            (rng.randn(cout) * 0.3).astype(np.float32),
        )

    stem_p = _stem_params(rng)
    sep_p = (sep(64, 128), sep(128, 128), sep(128, 128))
    skip_p = (
        (rng.randn(1, 1, 64, 128) * 0.1).astype(np.float32),
        (rng.rand(128) + 0.5).astype(np.float32),
        (rng.randn(128) * 0.3).astype(np.float32),
    )
    return stem_p, sep_p, skip_p


def _tree(fn, p):
    return tuple(_tree(fn, q) if isinstance(q, tuple) else fn(q) for q in p)


SHAPES = [(1, 64, 64), (1, 96, 128), (2, 64, 64)]


@pytest.mark.parametrize("n,h,w", SHAPES)
def test_fused_stem_block1_plain_matches_jax(n, h, w):
    rng = np.random.RandomState(2)
    x = rng.randn(n, h, w, 3).astype(np.float32)
    params = _block1_params(rng)
    want = np.asarray(jec.fused_stem_block1_ref(jnp.asarray(x), *_tree(jnp.asarray, params)))
    got = tec.fused_stem_block1(torch.from_numpy(x), *_tree(torch.from_numpy, params))
    assert got.shape == want.shape == (n, h // 4, w // 4, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,h,w", SHAPES)
def test_fused_stem_plain_matches_jax(n, h, w):
    rng = np.random.RandomState(1)
    x = rng.randn(n, h, w, 3).astype(np.float32)
    params = _stem_params(rng)
    want = np.asarray(jec.fused_stem_ref(jnp.asarray(x), *map(jnp.asarray, params)))
    got = tec.fused_stem(torch.from_numpy(x), *map(torch.from_numpy, params))
    assert got.shape == want.shape == (n, h // 2, w // 2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_fused_stem_block1_plain_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    params = _block1_params(rng)
    want = np.asarray(jec.fused_stem_block1(
        jnp.asarray(x), *_tree(jnp.asarray, params), strip=4, interpret=True
    ))
    got = tec.fused_stem_block1(torch.from_numpy(x), *_tree(torch.from_numpy, params))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32))
    stem_p, sep_p, skip_p = _tree(torch.from_numpy, _block1_params(rng))
    before = (tec.fused_stem.launches, tec.fused_stem_block1.launches)
    tec.fused_stem(x, *stem_p)
    tec.fused_stem_block1(x, stem_p, sep_p, skip_p)
    assert (tec.fused_stem.launches, tec.fused_stem_block1.launches) == before


def test_packed_parameters_match_kernel_layout():
    """The wrapper's packed weight buffer has the length the CUDA
    kernels read (csrc/entrychain.cu: kStemEnd, kBlock1End), with each
    conv weight rounded to the input dtype and the affines kept f32."""
    rng = np.random.RandomState(5)
    stem_p, sep_p, skip_p = _tree(torch.from_numpy, _block1_params(rng))
    x = torch.zeros(1, 64, 64, 3, dtype=torch.bfloat16)
    assert tec.pack_weights(x, stem_p).numel() == 19488
    packed = tec.pack_weights(x, stem_p, sep_p, skip_p)
    assert packed.numel() == 73184 and packed.dtype == torch.float32
    k1 = packed[:864].view(3, 3, 3, 32)
    assert torch.equal(k1, stem_p[0].to(torch.bfloat16).float())
    assert torch.equal(packed[864:896], stem_p[1])
    assert torch.equal(packed[-128:], skip_p[2])


def test_supported_gates_match_jax():
    for h, w, c in [(1024, 2048, 3), (64, 64, 3), (96, 128, 3), (1022, 2048, 3),
                    (64, 96, 3), (16, 64, 3), (64, 64, 4)]:
        assert tec.stem_supported(h, w, c) == jec.stem_supported(h, w, c)
        assert tec.stem_block1_supported(h, w, c) == jec.stem_block1_supported(h, w, c)
