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
    ("TPU.INT8_ACTIVATIONS", "full"),
    ("TPU.INT8_ACTIVATIONS", "true"),
    ("TPU.INT8_CALIBRATION_BATCHES", "2"),
])
def test_not_ported_knobs_raise(cfg, key, value):
    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list(["TPU.USE_PALLAS_SEPCONV", "true", "TPU.FUSED_SEPCONV_V3", "true",
                          "TPU.FUSED_ENTRY_V3", "block2,block3"])
    get_segmentation_model("cpu")  # these are ported, and so is TPU.INT8_ACTIVATIONS="pw"
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


def _undefined_globals(path):
    """Names that a scope of ``path`` reads as globals but that the module
    never binds, nor builtins hold: what a NameError would stop on."""
    import builtins
    import symtable

    top = symtable.symtable(open(path).read(), path, "exec")
    bound = set(dir(builtins)) | {"__file__", "__name__", "__doc__"}
    scopes, bad = [top], []
    while scopes:
        table = scopes.pop()
        scopes.extend(table.get_children())
        for sym in table.get_symbols():
            if (sym.is_assigned() or sym.is_imported()) and (
                    table is top or sym.is_declared_global()):
                bound.add(sym.get_name())
    scopes = [top]
    while scopes:
        table = scopes.pop()
        scopes.extend(table.get_children())
        for sym in table.get_symbols():
            if sym.is_referenced() and (table is top or sym.is_global()):
                bad.append((table.get_name(), sym.get_name()))
    return sorted({b for b in bad if b[1] not in bound})


def test_chip_smoke_reads_no_unbound_name():
    # chip_smoke.py only runs on the card, so a mode that reads another
    # function's locals would fail only there; a planted one must show here.
    path = os.path.join(REPO, "chip_smoke.py")
    assert _undefined_globals(path) == []
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        planted = os.path.join(tmp, "planted.py")
        with open(planted, "w") as f:
            f.write("def main():\n    flag = 1\n    return flag\n\n"
                    "def mode():\n    return flag\n")
        assert _undefined_globals(planted) == [("mode", "flag")]
