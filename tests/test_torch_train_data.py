"""The port's train data path (sampler, DataLoader, the host train and
val transforms, the device-augment items and ``DeviceAugment``, and
Cityscapes) against the JAX package's, on the CPU.

The JAX side's native host library is switched off (its ``_native``
module reports no library), so both packages run the PIL path. The
sampler, the host items, the device-augment items and the masks are
compared for equality; the normalized images of the host path within
1e-6 (the same f32 numpy arithmetic); ``DeviceAugment`` within 1e-5 of
max|value| (the same f32 products, summed in another order: the JAX
package's einsum at ``precision="highest"``, here ``torch.matmul`` with
TF32 off)."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import segmentron_tpu.data._native as jax_native
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.data import DataLoader as JaxLoader
from segmentron_tpu.data.dataloader.cityscapes import CitySegmentation as JaxCity
from segmentron_tpu.data.dataloader.synthetic import SyntheticSegmentation as JaxSynthetic
from segmentron_tpu.data.device_input import DeviceInput as JaxDeviceInput
from segmentron_tpu.ops.preprocess import DeviceAugment as JaxDeviceAugment
from segmentron_tpu.utils.distributed import make_data_sampler as jax_sampler
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.data import DataLoader, get_segmentation_dataset
from segmentron_tpu_torch.data.dataloader import CitySegmentation, SyntheticSegmentation
from segmentron_tpu_torch.data.device_input import DeviceInput, pil_nearest_indices
from segmentron_tpu_torch.ops import preprocess
from segmentron_tpu_torch.ops.preprocess import DeviceAugment
from segmentron_tpu_torch.utils.distributed import make_data_sampler

torch.set_num_threads(2)

IMAGE_TOL = 1e-6
AUGMENT_TOL = 1e-5
CROP, BASE = 64, 80
SOURCE, CANVAS = (72, 96), (80, 112)


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@pytest.fixture()
def cfgs(monkeypatch):
    monkeypatch.setattr(jax_native, "_TRIED", True)
    monkeypatch.setattr(jax_native, "_LIB", None)
    snapshots = jax_cfg.to_dict(), port_cfg.to_dict()
    for cfg in (jax_cfg, port_cfg):
        cfg.update_from_list(["TRAIN.CROP_SIZE", str(CROP), "TRAIN.BASE_SIZE", str(BASE)])
    yield jax_cfg, port_cfg
    _restore(jax_cfg, snapshots[0])
    _restore(port_cfg, snapshots[1])


@pytest.mark.parametrize("n,shuffle", [(10, True), (7, True), (5, False)])
def test_sampler_order_matches_jax(n, shuffle):
    for epoch in range(3):
        got = make_data_sampler(n, shuffle, 1024, epoch)
        np.testing.assert_array_equal(got, jax_sampler(n, shuffle, 1024, epoch))
    if shuffle:
        assert not np.array_equal(make_data_sampler(n, True, 1024, 0),
                                  make_data_sampler(n, True, 1024, 1))


def _pair(mode, length=6, device_input=False):
    jax_ds = JaxSynthetic(split="train", mode=mode, length=length, image_size=SOURCE)
    port_ds = SyntheticSegmentation(split="train", mode=mode, length=length, image_size=SOURCE)
    if device_input:
        jax_ds.device_input = JaxDeviceInput(jax_ds, canvas=CANVAS)
        port_ds.device_input = DeviceInput(port_ds, CANVAS)
    return jax_ds, port_ds


@pytest.mark.parametrize("mode", ["train", "val"])
def test_host_items_match_jax(cfgs, mode):
    """Host train items (flip, scale, pad, crop, blur; two epochs) and val
    items (short side to the crop, centre crop)."""
    jax_ds, port_ds = _pair(mode)
    for epoch in (0, 1):
        jax_ds.set_epoch(epoch)
        port_ds.set_epoch(epoch)
        for i in range(len(port_ds)):
            (ji, jm, jn), (pi, pm, pn) = jax_ds[i], port_ds[i]
            assert pi.shape == ji.shape == (CROP, CROP, 3) and pi.dtype == np.float32
            np.testing.assert_allclose(pi, ji, rtol=0, atol=IMAGE_TOL)
            np.testing.assert_array_equal(pm, jm)
            assert pm.dtype == np.int32 and pn == jn


def test_loader_batches_match_jax(cfgs):
    """Two epochs of shuffled train batches (drop_last by default) and the
    val batches with their ragged tail."""
    jax_ds, port_ds = _pair("train", length=7)
    jl = JaxLoader(jax_ds, batch_size=3, shuffle=True, seed=5, num_workers=2, prefetch=1)
    pl = DataLoader(port_ds, batch_size=3, shuffle=True, seed=5, num_workers=2, prefetch=1,
                    device="cpu")
    assert len(pl) == len(jl) == 2 and pl.drop_last
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["name"] == w["name"]
            assert isinstance(g["image"], torch.Tensor) and g["image"].device.type == "cpu"
            np.testing.assert_allclose(g["image"].numpy(), np.asarray(w["image"]), rtol=0,
                                       atol=IMAGE_TOL)
            np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))
    jax_ds, port_ds = _pair("val", length=5)
    jl = JaxLoader(jax_ds, batch_size=2, num_workers=2, prefetch=0)
    pl = DataLoader(port_ds, batch_size=2, num_workers=2, prefetch=0, device="cpu")
    got, want = list(pl), list(jl)
    assert len(pl) == 3 and [b["image"].shape[0] for b in got] == [2, 2, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(w["image"]), rtol=0,
                                   atol=IMAGE_TOL)
        np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))


def test_device_items_match_jax(cfgs):
    """``build_train_item``: the canvas, the mapped mask, the draws and the
    mask's row and column indices, key for key and bit for bit."""
    jax_ds, port_ds = _pair("train", length=8, device_input=True)
    assert port_ds.device_input.pad_label == jax_ds.device_input.pad_label
    for i in range(len(port_ds)):
        got, want = port_ds[i][0], jax_ds[i][0]
        assert got.keys() == want.keys()
        for key in want:
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _device_batch(length=8):
    jax_ds, port_ds = _pair("train", length=length, device_input=True)
    items = [port_ds[i][0] for i in range(length)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}, port_ds, jax_ds


def test_device_augment_matches_jax(cfgs):
    """``DeviceAugment.apply`` on a batch with flips, pads (a scaled short
    side below the crop), blurs and unblurred samples."""
    batch, port_ds, _ = _device_batch()
    geom = batch["aug_geom"]
    assert geom[:, 6].any() and not geom[:, 6].all()  # flipped and not
    assert (np.minimum(geom[:, 2], geom[:, 3]) < CROP).any()  # padded
    assert (batch["aug_sigma"] > 0).any() and (batch["aug_sigma"] == 0).any()
    mean, std = list(port_cfg.DATASET.MEAN), list(port_cfg.DATASET.STD)
    pad = port_ds.device_input.pad_label
    want_img, want_mask = JaxDeviceAugment(CROP, mean, std, pad).apply(
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    got_img, got_mask = DeviceAugment(CROP, mean, std, pad).apply(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    want_img = np.asarray(want_img)
    assert got_img.shape == want_img.shape == (8, CROP, CROP, 3)
    assert got_img.dtype == torch.float32 and got_mask.dtype == torch.int32
    scale = float(np.abs(want_img).max())
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=AUGMENT_TOL * scale)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert (batch["row_sel"] < 0).any() or (batch["col_sel"] < 0).any()  # a padded crop


def test_device_augment_equals_host_masks(cfgs):
    """The mask crop from PIL's own nearest indices equals the host
    path's mask for the same draws (the same sample, the same epoch)."""
    batch, port_ds, _ = _device_batch(length=4)
    _, masks = DeviceAugment(CROP, [0, 0, 0], [1, 1, 1], port_ds.device_input.pad_label).apply(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    host = SyntheticSegmentation(split="train", mode="train", length=4, image_size=SOURCE)
    for i in range(4):
        np.testing.assert_array_equal(masks[i].numpy(), host[i][1])
    np.testing.assert_array_equal(pil_nearest_indices(4, 7),
                                  np.asarray(Image.fromarray(np.arange(4, dtype=np.int32)[None],
                                                             mode="I").resize((7, 1),
                                                                              Image.NEAREST))[0])


def test_no_tf32_restores_the_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with preprocess._no_tf32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _city_tree(root, split, n_cities=2, per_city=2, h=48, w=96):
    """A tiny Cityscapes layout: raw label ids from the 19 valid ones, 0
    and two other ignored ids."""
    rng = np.random.RandomState(3)
    ids = np.array([0, 1, 4, 7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31,
                    32, 33], np.uint8)
    for c in range(n_cities):
        city = f"city{c}"
        for k in range(per_city):
            stem = f"{city}_{k:06d}_000019"
            img_dir = os.path.join(root, "leftImg8bit", split, city)
            mask_dir = os.path.join(root, "gtFine", split, city)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(mask_dir, exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(img_dir, f"{stem}_leftImg8bit.png"))
            coarse = ids[rng.randint(0, len(ids), (h // 8, w // 8))]
            Image.fromarray(np.kron(coarse, np.ones((8, 8), np.uint8))).save(
                os.path.join(mask_dir, f"{stem}_gtFine_labelIds.png"))


@pytest.mark.parametrize("mode", ["train", "val", "testval"])
def test_cityscapes_matches_jax(cfgs, tmp_path, mode):
    """Pairs, length, the 34 -> 19 lookup (ignored ids to -1) and the
    items of each mode against the JAX class on a tiny tree."""
    root = str(tmp_path / "cityscapes")
    _city_tree(root, "train")
    port = get_segmentation_dataset("cityscapes", root=root, split="train", mode=mode,
                                    device_normalize=False)
    jax_ds = JaxCity(root=root, split="train", mode=mode)
    assert isinstance(port, CitySegmentation) and len(port) == len(jax_ds) == 4
    assert port.images == jax_ds.images and port.masks == jax_ds.masks
    assert port.DEVICE_CANVAS == JaxCity.DEVICE_CANVAS == (1024, 2048)
    for i in range(len(port)):
        (pi, pm, pn), (ji, jm, jn) = port[i], jax_ds[i]
        assert pn == jn
        np.testing.assert_allclose(pi, ji, rtol=0, atol=IMAGE_TOL)
        np.testing.assert_array_equal(pm, jm)
        assert set(np.unique(pm)) <= set(range(-1, 19))
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    lut = port._mask_transform(Image.fromarray(raw))
    np.testing.assert_array_equal(lut, jax_ds._mask_transform(Image.fromarray(raw)))
    assert (lut >= 0).sum() == 19
    with pytest.raises(RuntimeError):
        get_segmentation_dataset("citys", root=str(tmp_path / "none"), split="val", mode="val")
