"""The port's test-time augmentation (segmentron_tpu_torch/engine/tta.py)
against the JAX package's ``engine/tta.py`` on the CPU.

One cheap deterministic predictor, written in both frameworks, stands in
for a model, so nothing compiles but the JAX package's TTA programs: per
pixel a linear map of the three channels plus one of the window's mean
colour, so a window's content, its pad and its place on the grid all
reach the logits. Cases: scales (0.5, 0.75, 1.0, 1.25) with and without
flip; sliding windows smaller than the image (stride ceil(crop * 2/3)),
one larger than it (the zero pad), an odd size; a raw uint8 input, which
both packages normalize before the pad and the resizes.

Tolerance: the JAX package resizes by two f32 interpolation matrices,
the port by ``F.interpolate``, and each computes the softmax its own way;
at these sizes the summed probabilities and the stitched logits differ by
at most 5.7e-6 (measured; a last-bit difference of logits near 10), held
at 1e-5. A port that pads a uint8 image before
normalizing it puts -mean/std (~ -2) in the apron instead of 0 and misses
the JAX result by more than 0.1 (``test_pad_after_normalize``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentron_tpu.engine.tta as jax_tta
from segmentron_tpu_torch.engine import tta

torch.set_num_threads(2)

NCLASS = 5
TOL = 1e-5


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, NCLASS).astype(np.float32), rng.randn(NCLASS).astype(np.float32),
            rng.randn(3, NCLASS).astype(np.float32))


def _predictors(seed=0):
    """(JAX ``predict(variables, x)``, port ``predict(x)``), the same
    function: x W + b + mean_hw(x) V, f32 logits."""
    w, b, v = _weights(seed)

    def jax_predict(variables, x):
        x = x.astype(jnp.float32)
        return x @ w + b + jnp.mean(x, axis=(1, 2), keepdims=True) @ v

    wt, bt, vt = (torch.from_numpy(a) for a in (w, b, v))

    def port_predict(x):
        x = x.float()
        return x @ wt + bt + x.mean(dim=(1, 2), keepdim=True) @ vt

    return jax_predict, port_predict


def _image(shape, seed=1, uint8=False):
    rng = np.random.RandomState(seed)
    if uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.randn(*shape).astype(np.float32)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_grid_positions_match_jax():
    for ph, pw, crop, stride in ((20, 28, 12, 8), (17, 23, 11, 8), (32, 32, 32, 22),
                                 (769, 1537, 769, 513), (1024, 2048, 769, 513)):
        assert tta._grid_positions(ph, pw, crop, stride) == jax_tta._grid_positions(
            ph, pw, crop, stride)


@pytest.mark.parametrize("flip", [False, True])
def test_multi_scale_matches_jax(flip):
    jp, pp = _predictors()
    x = _image((2, 20, 28, 3))
    scales = (0.5, 0.75, 1.0, 1.25)
    want = jax_tta.multi_scale_predict(jp, None, jnp.asarray(x), NCLASS, scales=scales,
                                       flip=flip)
    got = tta.multi_scale_predict(pp, torch.from_numpy(x), NCLASS, scales=scales, flip=flip)
    _close(got, want)
    # four scales (and flips) of probabilities summed: the total is their count
    np.testing.assert_allclose(got.sum(-1).numpy(), len(scales) * (1 + flip), rtol=1e-5)


@pytest.mark.parametrize("shape,crop", [
    ((2, 20, 28, 3), 12),   # windows smaller than the image, two images
    ((1, 20, 28, 3), 32),   # one window larger than the image: the zero pad
    ((1, 17, 23, 3), 11),   # odd size, ragged last row and column of windows
    ((1, 20, 28, 3), 20),   # one side exactly the crop
])
def test_predict_sliding_matches_jax(shape, crop):
    jp, pp = _predictors(seed=2)
    x = _image(shape, seed=3)
    want = jax_tta.predict_sliding(jp, None, jnp.asarray(x), crop, NCLASS)
    got = tta.predict_sliding(pp, torch.from_numpy(x), crop, NCLASS)
    _close(got, want)


@pytest.mark.parametrize("shape,scales,flip,crop", [
    ((1, 20, 28, 3), (0.75, 1.0, 1.25), True, 16),  # sliding at 1.0 and 1.25, whole at 0.75
    ((1, 17, 23, 3), (0.5, 1.0), False, 11),        # odd size: sliding only at 1.0
    ((1, 20, 28, 3), (1.0,), False, 40),            # crop larger than every scale: whole
])
def test_multi_scale_sliding_matches_jax(shape, scales, flip, crop):
    jp, pp = _predictors(seed=4)
    x = _image(shape, seed=5)
    want = jax_tta.multi_scale_predict(jp, None, jnp.asarray(x), NCLASS, scales=scales,
                                       flip=flip, crop_size=crop)
    got = tta.multi_scale_predict(pp, torch.from_numpy(x), NCLASS, scales=scales, flip=flip,
                                  crop_size=crop)
    _close(got, want)


def test_pad_after_normalize(monkeypatch):
    """A raw uint8 image is normalized before the pad and the resizes, as
    the JAX package does; a port that pads first (the predictor then
    normalizing, as ``make_predict_fn`` does) puts -mean/std in the apron
    and misses."""
    jp, pp = _predictors(seed=6)
    x = _image((1, 20, 28, 3), seed=7, uint8=True)
    kw = dict(scales=(0.75, 1.0), flip=True, crop_size=24)
    want = jax_tta.multi_scale_predict(jp, None, jnp.asarray(x), NCLASS, **kw)
    got = tta.multi_scale_predict(pp, torch.from_numpy(x), NCLASS, **kw)
    _close(got, want)
    sliding = jax_tta.predict_sliding(jp, None, jnp.asarray(x), 24, NCLASS)
    _close(tta.predict_sliding(pp, torch.from_numpy(x), 24, NCLASS), sliding)

    normalize = tta._normalize
    monkeypatch.setattr(tta, "_normalize", lambda image: image)  # planted: pad the raw pixels

    bad = tta.predict_sliding(lambda images: pp(normalize(images)), torch.from_numpy(x), 24,
                              NCLASS)
    assert np.abs(bad.numpy() - np.asarray(sliding)).max() > 0.1
