"""The port's flash-attention backward (segmentron_tpu_torch/ops/attention.py:
``flash_attention_bwd_plain``, the plain version of the two CUDA backward
kernels, and the autograd function ``FlashAttention``) against the JAX
package's, on the CPU: ``_attention_pallas_bwd`` in interpret mode on the
same q, k, v, do, out and lse (f32 to 2e-5; a bf16 case to one bf16 ulp),
and ``jax.grad`` of ``_attention_xla`` (rtol/atol 1e-4, as
tests/test_attention_pallas.py holds the Pallas gradients). The wrapper
computes the plain version for CPU tensors only and raises, never falling
back, for a device it cannot launch on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.ops import attention as jax_attention
from segmentron_tpu_torch.ops import attention

torch.set_num_threads(2)

TOL = 2e-5
GRAD_TOL = 1e-4  # tests/test_attention_pallas.py


def _inputs(n, p, dk, dv, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32)
                 for s in ((n, p, dk), (n, p, dk), (n, p, dv), (n, p, dv)))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


@pytest.mark.parametrize("n,p,dk,dv,scale,block_q,block_k", [
    (2, 600, 32, 64, 1.0, 256, 256),   # ragged P: keys and rows past P
    (1, 384, 32, 32, 0.25, 256, 128),  # block_q != block_k, P padded to 512
])
def test_plain_matches_pallas_bwd(n, p, dk, dv, scale, block_q, block_k):
    q, k, v, do = _inputs(n, p, dk, dv)
    out, lse = jax_attention._attention_pallas(q, k, v, scale=scale, block_q=block_q,
                                               block_k=block_k, interpret=True)
    want = jax_attention._attention_pallas_bwd(q, k, v, do, out, lse, scale, block_q=block_q,
                                               block_k=block_k, interpret=True)
    got = attention.flash_attention_bwd_plain(*_torch(q, k, v, do, out, lse), scale,
                                              block_q=block_q, block_k=block_k)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


def test_plain_matches_pallas_bwd_bf16():
    """bf16 inputs: both cast to f32, compute in f32 and round each
    gradient once to bf16, so they agree to one bf16 ulp."""
    n, p, dk, dv, scale = 1, 300, 32, 64, 0.5
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(n, p, dk, dv, seed=1))
    out, lse = jax_attention._attention_pallas(q, k, v, scale=scale, block_q=128, block_k=128,
                                               interpret=True)
    want = jax_attention._attention_pallas_bwd(q, k, v, do, out, lse, scale, block_q=128,
                                               block_k=128, interpret=True)
    tq, tk, tv, tdo, tout = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                             for a in (q, k, v, do, out))
    got = attention.flash_attention_bwd_plain(tq, tk, tv, tdo, tout,
                                              torch.from_numpy(np.array(lse)), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g.float().numpy() - w) <= ulp), name


@pytest.mark.parametrize("n,p,dk,dv,scale", [(1, 300, 16, 16, 0.25), (2, 600, 32, 64, 1.0)])
def test_flash_attention_grads_match_xla(n, p, dk, dv, scale):
    """``FlashAttention`` (plain forward and backward on the CPU) against
    ``jax.grad`` of the dense XLA attention."""
    q, k, v, do = _inputs(n, p, dk, dv, seed=2)

    def loss(q, k, v):
        return jnp.sum(jax_attention._attention_xla(q, k, v, scale) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    (attention.FlashAttention.apply(tq, tk, tv, scale) * torch.from_numpy(do)).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_flash_route_grads_match_dense_route():
    """``spatial_attention``'s flash route (P >= 2048) and its dense route
    give the same q, k, v gradients under autograd."""
    q, k, v, do = _torch(*_inputs(1, 2304, 16, 32, seed=3))
    grads = {}
    for route in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention.spatial_attention(*leaves, scale=0.25, use_pallas=route)
        (out * do).sum().backward()
        grads[route] = [t.grad for t in leaves]
        assert out.grad_fn is not None
    for g, w in zip(grads[True], grads[False]):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL * w.abs().max().item())


def test_wrappers_raise_off_cpu_and_count_nothing():
    """A tensor on a device the kernels cannot launch on (here ``meta``):
    the backward raises instead of computing the plain version, and no
    launch is counted."""
    before = (attention.flash_attention_bwd_dq.launches,
              attention.flash_attention_bwd_dkv.launches)
    q, k = (torch.empty(1, 64, 32, device="meta") for _ in range(2))
    v, do, out = (torch.empty(1, 64, 128, device="meta") for _ in range(3))
    lse = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        attention.flash_attention_bwd(q, k, v, do, out, lse, 1.0)
    with pytest.raises(ValueError, match="unsupported devices"):
        attention.FlashAttention.apply(q, k, v, 1.0)
    assert (attention.flash_attention_bwd_dq.launches,
            attention.flash_attention_bwd_dkv.launches) == before


def test_flash_attention_in_inference_mode():
    """Under ``torch.inference_mode`` the flash route is the forward alone."""
    q, k, v, _ = _torch(*_inputs(1, 2048, 16, 32, seed=4))
    with torch.inference_mode():
        out = attention.spatial_attention(q, k, v, use_pallas=True)
    torch.testing.assert_close(out, attention._attention_dense(q, k, v, 1.0), rtol=2e-4,
                               atol=2e-4)
