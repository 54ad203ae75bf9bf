"""The port's spatial attention (segmentron_tpu_torch/ops/attention.py)
against the JAX package's, on the CPU: ``flash_attention_plain``, the
plain version of the flash-attention kernel, against ``_attention_xla``
and against the Pallas kernel ``_attention_pallas`` in interpret mode, out
and lse; ``spatial_attention``'s routes. Tolerances as in
tests/test_attention_pallas.py: f32 rtol/atol 2e-4 on out, 1e-4 on lse."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.ops import attention as jax_attention
from segmentron_tpu_torch.ops import attention

torch.set_num_threads(2)

OUT_TOL = 2e-4
LSE_TOL = 1e-4


def _qkv(n, p, dk, dv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, p, dk).astype(np.float32), rng.randn(n, p, dk).astype(np.float32),
            rng.randn(n, p, dv).astype(np.float32))


def _dense_lse(q, k, scale):
    energy = np.einsum("npc,nqc->npq", q.astype(np.float64), k.astype(np.float64)) * scale
    top = energy.max(-1)
    return np.log(np.exp(energy - top[..., None]).sum(-1)) + top


def _plain(q, k, v, scale, **kw):
    out, lse = attention.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale, **kw)
    return out.numpy(), lse.numpy()


CASES = [(2, 600, 32, 64, 1.0), (2, 1024, 64, 64, 0.125)]


@pytest.mark.parametrize("block_k", [4096, 256])
@pytest.mark.parametrize("n,p,dk,dv,scale", CASES)
def test_plain_matches_xla(n, p, dk, dv, scale, block_k):
    q, k, v = _qkv(n, p, dk, dv)
    out, lse = _plain(q, k, v, scale, block_k=block_k)
    want = np.asarray(jax_attention._attention_xla(q, k, v, scale))
    np.testing.assert_allclose(out, want, rtol=OUT_TOL, atol=OUT_TOL)
    assert lse.shape == (n, p) and lse.dtype == np.float32
    np.testing.assert_allclose(lse, _dense_lse(q, k, scale), rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("n,p,dk,dv,scale,block_q,block_k", [
    (2, 600, 32, 64, 1.0, 256, 256),
    (2, 1024, 64, 64, 0.125, 256, 256),
    # block_q != block_k: P = 384 is a multiple of block_k yet padded to
    # 512, so the mask must still apply (tests/test_attention_pallas.py)
    (1, 384, 32, 32, 1.0, 256, 128),
])
def test_plain_matches_pallas_interpret(n, p, dk, dv, scale, block_q, block_k):
    q, k, v = _qkv(n, p, dk, dv, seed=1)
    want_out, want_lse = jax_attention._attention_pallas(
        q, k, v, scale=scale, block_q=block_q, block_k=block_k, interpret=True)
    out, lse = _plain(q, k, v, scale, block_k=block_k)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=LSE_TOL, atol=LSE_TOL)


def test_plain_bf16_rounds_p_like_the_pallas_kernel():
    """In bf16 both round p to v's type before the product: the same
    blocks give the same bf16 outputs up to one bf16 ulp of f32 summation
    order, while the dense route (p kept in f32) is further off."""
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(1, 512, 32, 64, seed=2))
    want, want_lse = jax_attention._attention_pallas(
        q, k, v, scale=0.5, block_q=128, block_k=128, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
                  for x in (q, k, v))
    out, lse = attention.flash_attention_plain(tq, tk, tv, 0.5, block_k=128)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
    assert np.all(np.abs(out.float().numpy() - want) <= ulp)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=LSE_TOL, atol=LSE_TOL)
    dense = attention._attention_dense(tq, tk, tv, 0.5).float().numpy()
    assert np.abs(dense - want).max() > np.abs(out.float().numpy() - want).max()


@pytest.fixture()
def flash_calls(monkeypatch):
    """Calls of the port's flash route."""
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("p,use_pallas,flash", [
    (2100, True, True),    # the gated route: P >= 2048
    (2100, False, False),
    (2047, True, False),
])
def test_spatial_attention_routes_match_jax(flash_calls, p, use_pallas, flash):
    q, k, v = _qkv(1, p, 16, 32, seed=3)
    scale = 16 ** -0.5
    want = np.asarray(jax_attention.spatial_attention(q, k, v, scale=scale,
                                                      use_pallas=use_pallas))
    attention.flash_attention.launches = 0
    got = attention.spatial_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), scale=scale, use_pallas=use_pallas)
    assert len(flash_calls) == int(flash)
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_TOL, atol=OUT_TOL)
    assert attention.flash_attention.launches == 0  # no kernel launches on the CPU


def test_flash_attention_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    one on the meta device is refused before any build."""
    q = torch.empty(1, 2048, 64, device="meta")
    v = torch.empty(1, 2048, 512, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        attention.flash_attention(q, q, v, 1.0)
    assert attention.flash_attention.launches == 0
