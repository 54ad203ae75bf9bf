"""The port's Evaluator and metric against the JAX package, on the CPU:
the same synthetic uint8 images and the same converted weights give the
same confusion matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.data.dataloader.synthetic import SyntheticSegmentation as JaxSynthetic
from segmentron_tpu.models.deeplabv3_plus import DeepLabV3Plus as JaxDeepLabV3Plus
from segmentron_tpu.modules.batch_norm import NormConfig as JaxNorm
from segmentron_tpu.ops.preprocess import normalize_u8 as jax_normalize_u8
from segmentron_tpu.utils.score import SegmentationMetric as JaxMetric
from segmentron_tpu.utils.score import confusion_matrix_update as jax_cm
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
from segmentron_tpu_torch.engine import Evaluator
from segmentron_tpu_torch.models import get_segmentation_model
from segmentron_tpu_torch.utils import SegmentationMetric, confusion_matrix_update
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
LOGIT_TOL = 1e-3  # tests/test_model_parity.py, full-model logits


@pytest.fixture()
def eval_cfg(fresh_cfg):
    """Both packages' cfgs: the flagship YAML, 2 middle blocks, f32, the
    synthetic set; the port's restored afterwards."""
    snapshot = port_cfg.to_dict()
    for cfg in (port_cfg, fresh_cfg):
        cfg.update_from_file(FLAGSHIP)
        cfg.update_from_list(["MODEL.XCEPTION.MIDDLE_BLOCKS", "2", "DATASET.NAME", "synthetic",
                              "TPU.COMPUTE_DTYPE", "float32"])
    yield port_cfg
    port_cfg.defrost()
    port_cfg.clear()
    for k, v in type(port_cfg)(snapshot).items():
        dict.__setitem__(port_cfg, k, v)


def test_evaluator_confusion_matrix_matches_jax(eval_cfg):
    nclass = 19
    dataset = SyntheticSegmentation(split="val", mode="testval", length=2, image_size=(64, 128))
    jax_data = JaxSynthetic(split="val", mode="testval", length=2, image_size=(64, 128))
    images, masks = [], []
    for i in range(2):
        img, mask, _ = dataset[i]
        jimg, jmask = (np.asarray(a) for a in jax_data._make_pair(i))
        assert img.dtype == np.uint8 and np.array_equal(img, jimg)
        assert np.array_equal(mask, jmask.astype(np.int32))
        images.append(img)
        masks.append(mask)

    model = JaxDeepLabV3Plus(
        nclass=nclass, backbone="xception65", encoder_norm=JaxNorm(eps=1e-3),
        decoder_norm=JaxNorm(), output_stride=16,
    )
    x = np.stack(images)
    variables = jax_variables(model, x[:1].astype(np.float32))
    mean, std = list(jax_cfg.DATASET.MEAN), list(jax_cfg.DATASET.STD)
    logits = np.asarray(jax.jit(lambda v, x: model.apply(v, jax_normalize_u8(x, mean, std),
                                                         False)[0])(variables, x))
    want_cm = np.asarray(jax_cm(jnp.asarray(logits.argmax(-1)), jnp.asarray(np.stack(masks)),
                                nclass))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tol = LOGIT_TOL * max(1.0, float(np.abs(logits).max()))
    ambiguous = int(((top2[..., 1] - top2[..., 0]) < tol).sum())

    port_model = get_segmentation_model("cpu")
    port_model.load_state_dict(from_flax_variables(variables), strict=True)
    evaluator = Evaluator(port_model, dataset, device="cpu")
    pix_acc, miou, _ = evaluator.eval()
    got_cm = evaluator.metric.confusion_matrix
    assert got_cm.sum() == want_cm.sum() == 2 * 64 * 128
    # a pixel whose top-2 margin is inside the logits tolerance may flip:
    # it moves one count between two cells
    assert np.abs(got_cm - want_cm).sum() <= 2 * ambiguous
    if ambiguous == 0:
        np.testing.assert_array_equal(got_cm, want_cm)
    jax_metric = JaxMetric(nclass)
    jax_metric.update_cm(got_cm)
    assert (pix_acc, miou) == pytest.approx(jax_metric.get())


def test_confusion_matrix_and_scores_match_jax():
    rng = np.random.RandomState(0)
    nclass = 7
    pred = rng.randint(0, nclass, (3, 17, 23))
    target = rng.randint(-1, nclass + 2, (3, 17, 23))  # ignore -1 and out of range
    want = np.asarray(jax_cm(jnp.asarray(pred), jnp.asarray(target), nclass))
    got = confusion_matrix_update(torch.from_numpy(pred), torch.from_numpy(target), nclass)
    np.testing.assert_array_equal(got.numpy(), want)

    port, ref = SegmentationMetric(nclass), JaxMetric(nclass)
    logits = rng.randn(2, 9, 11, nclass).astype(np.float32)
    labels = rng.randint(-1, nclass, (2, 9, 11))
    port.update(torch.from_numpy(logits), torch.from_numpy(labels))
    ref.update(logits, labels)
    np.testing.assert_array_equal(port.confusion_matrix, ref.confusion_matrix)
    assert port.get() == pytest.approx(ref.get())


@pytest.mark.parametrize("key,value", [
    ("TPU.INT8_ACTIVATIONS", "full"), ("TPU.INT8_CALIBRATE", "true"),
    ("TPU.INT8_CALIBRATION_BATCHES", "2"),
    ("TEST.BUCKET_QUANT", "32"), ("TEST.SPATIAL_SHARD", "true"),
])
def test_evaluator_unported_modes_raise(eval_cfg, key, value):
    eval_cfg.update_from_list([key, value])
    with pytest.raises(NotImplementedError):
        Evaluator(dataset=SyntheticSegmentation(mode="testval", length=1, image_size=(64, 64)),
                  device="cpu")
