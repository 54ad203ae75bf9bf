"""The port's config, model factory and import boundary, on the CPU."""

import ast
import glob
import os

import pytest
import torch

from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.models import get_segmentation_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "cityscapes_deeplabv3_plus_xception65.yaml")


@pytest.fixture()
def cfg():
    """A scratch copy of the port's cfg installed in place of the global
    one, restored afterwards."""
    snapshot = port_cfg.to_dict()
    yield port_cfg
    port_cfg.defrost()
    port_cfg.clear()
    for k, v in type(port_cfg)(snapshot).items():
        dict.__setitem__(port_cfg, k, v)


def test_defaults_match_jax_config():
    want = jax_cfg.to_dict()
    got = port_cfg.to_dict()
    for tree in (want, got):
        tree.pop("TIME_STAMP")
    assert got == want


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_every_yaml_loads(path):
    port_cfg.clone().update_from_file(path)


def test_flagship_yaml_builds_model(cfg):
    cfg.update_from_file(FLAGSHIP)
    assert cfg.MODEL.BN_EPS_FOR_ENCODER == 0.001
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.TPU.FUSED_STEM == "block1"
    model = get_segmentation_model("cpu")
    assert model.classifier.out_channels == 19
    assert model.backbone.middle_blocks == 16 and model.backbone.fused_stem == "block1"
    encoder_eps = {m.eps for m in model.backbone.modules() if isinstance(m, torch.nn.BatchNorm2d)}
    decoder_eps = {m.eps for m in model.head.modules() if isinstance(m, torch.nn.BatchNorm2d)}
    assert encoder_eps == {0.001} and decoder_eps == {1e-5}
    assert model.backbone.conv1.conv.weight.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("key,value", [
    ("TPU.INT8_ACTIVATIONS", "pw"),
    ("TPU.USE_PALLAS_SEPCONV", "true"),
    ("TPU.FUSED_SEPCONV_V3", "true"),
])
def test_not_ported_knobs_raise(cfg, key, value):
    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list([key, value])
    with pytest.raises(NotImplementedError):
        get_segmentation_model("cpu")


def test_entry_points_raise_without_a_card(cfg, monkeypatch):
    from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation
    from segmentron_tpu_torch.engine import Evaluator, make_predict_fn

    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list(["MODEL.XCEPTION.MIDDLE_BLOCKS", "1", "DATASET.NAME", "synthetic"])
    model = get_segmentation_model("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_segmentation_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predict_fn(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(model, SyntheticSegmentation(mode="testval", length=1, image_size=(64, 64)))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = glob.glob(os.path.join(REPO, "segmentron_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "segmentron_tpu"), (path, name)
