"""``python -m segmentron_tpu_torch.tools.eval`` on the CPU against the JAX
package's ``Evaluator`` (its ``tools/eval.py`` body) on the same weights.

The flagship YAML cut to 2 middle blocks, f32, two synthetic 64x96
images (uint8, normalized on the device), with ``TEST.SCALES [0.75, 1.0,
1.25]``, ``TEST.FLIP True`` and ``TEST.CROP_SIZE 80``: scale 0.75 runs
whole, 1.0 and 1.25 by two sliding windows each (the first padded). The
port restores a snapshot written by its own ``CheckpointManager``: the
latest one, and the best one with ``--best``, each holding other weights
(the JAX package's variables from two seeds, through the weight bridge);
the JAX ``Evaluator`` takes those variables directly (``variables=``).
The confusion matrices are held to at most 0.5 % of the labelled pixels
moved between cells, as in tests/test_torch_trainer.py (measured: 0 and
0 here). Then the setups both packages refuse alike: a ``TEST.CROP_SIZE``
list (the serving YAMLs' ``[1024, 2048]``: ``int(crop)`` raises
``TypeError`` in both), a missing snapshot or best snapshot
(``FileNotFoundError``), and an empty ``TEST.TEST_MODEL_PATH``, which
warns and evaluates the random model.
"""

import contextlib

import numpy as np
import pytest
import torch

import segmentron_tpu.data._native as jax_native
from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.data import dataloader as jax_datasets
from segmentron_tpu.engine.evaluator import Evaluator as JaxEvaluator
from segmentron_tpu.models import get_segmentation_model as jax_model_zoo
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.data import dataloader as port_datasets
from segmentron_tpu_torch.tools import eval as eval_tool
from segmentron_tpu_torch.utils.checkpoint import CheckpointManager
from segmentron_tpu_torch.utils.convert import from_flax_variables
from test_torch_modules import jax_variables

torch.set_num_threads(2)

FLAGSHIP = "configs/cityscapes_deeplabv3_plus_xception65.yaml"
CM_MOVED = 0.005
N_IMAGES, IMAGE_SIZE = 2, (64, 96)
OPTS = ["DATASET.NAME", "synthetic", "MODEL.XCEPTION.MIDDLE_BLOCKS", "2",
        "TPU.COMPUTE_DTYPE", "float32", "DATASET.WORKERS", "1", "TPU.PREFETCH", "1",
        "TIME_STAMP", "eval"]
TTA_OPTS = ["TEST.SCALES", "[0.75, 1.0, 1.25]", "TEST.FLIP", "True", "TEST.CROP_SIZE", "80"]


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@contextlib.contextmanager
def _cfg(cfg, opts):
    snapshot = cfg.to_dict()
    cfg.update_from_file(FLAGSHIP)
    cfg.update_from_list(opts)
    try:
        yield cfg
    finally:
        _restore(cfg, snapshot)


def _synthetic(module):
    class Synthetic(module.SyntheticSegmentation):
        def __init__(self, **kwargs):
            super().__init__(length=N_IMAGES, image_size=IMAGE_SIZE, **kwargs)

    return Synthetic


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ``Evaluator``'s confusion matrices on two sets of variables,
    and a snapshot directory holding them for the port (latest: seed 0,
    best: seed 1)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_TRIED", True)
        mp.setattr(jax_native, "_LIB", None)
        mp.setitem(jax_datasets.datasets, "synthetic", _synthetic(jax_datasets))
        with _cfg(jax_cfg, OPTS + TTA_OPTS):
            x = np.zeros((1,) + IMAGE_SIZE + (3,), np.float32)
            model = jax_model_zoo()
            variables = {name: jax_variables(model, x, seed=seed)
                         for name, seed in (("latest", 0), ("best", 1))}
            ev = JaxEvaluator(variables=variables["latest"])
            for name in ("latest", "best"):
                ev.variables = variables[name]
                ev.eval()
                out[name] = ev.metric.confusion_matrix
    snapshots = tmp_path_factory.mktemp("eval") / "snapshots"
    ckpt = CheckpointManager(str(snapshots))
    ckpt.save(4, {"step": 4, "model": from_flax_variables(variables["latest"])})
    ckpt.save_best(2, {"step": 2, "model": from_flax_variables(variables["best"])}, 0.5)
    out["dir"] = str(snapshots)
    return out


@pytest.fixture()
def port_synthetic(monkeypatch, tmp_path):
    monkeypatch.setitem(port_datasets.datasets, "synthetic", _synthetic(port_datasets))
    snapshot = port_cfg.to_dict()
    yield ["ROOT_PATH", str(tmp_path)]
    _restore(port_cfg, snapshot)


@pytest.mark.parametrize("which", ["latest", "best"])
def test_tools_eval_matches_jax(reference, port_synthetic, which):
    assert not np.array_equal(reference["latest"], reference["best"])
    argv = ["--config-file", FLAGSHIP, *(["--best"] if which == "best" else []), *OPTS,
            *TTA_OPTS, "TEST.TEST_MODEL_PATH", reference["dir"], *port_synthetic]
    evaluator = eval_tool.main(argv, device="cpu")
    got, want = evaluator.metric.confusion_matrix, reference[which]
    assert got.sum() == want.sum() > 0
    moved = np.abs(got - want).sum() / 2
    assert moved <= CM_MOVED * want.sum(), (moved, want.sum())


def test_crop_size_list_raises_as_jax(port_synthetic, tmp_path):
    """The serving YAMLs' ``TEST.CROP_SIZE: [1024, 2048]``, read from a
    YAML as a list: both packages pass ``int(crop)`` to the TTA, which
    refuses it."""
    text = open(FLAGSHIP).read()
    assert "TEST:\n  SCALES" in text
    yaml = tmp_path / "crop_list.yaml"
    yaml.write_text(text.replace("TEST:\n  SCALES", "TEST:\n  CROP_SIZE: [64, 96]\n  SCALES"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_TRIED", True)
        mp.setattr(jax_native, "_LIB", None)
        mp.setitem(jax_datasets.datasets, "synthetic", _synthetic(jax_datasets))
        with _cfg(jax_cfg, OPTS):
            jax_cfg.update_from_file(str(yaml))
            jax_cfg.update_from_list(OPTS)
            assert list(jax_cfg.TEST.CROP_SIZE) == [64, 96]
            x = np.zeros((1,) + IMAGE_SIZE + (3,), np.float32)
            ev = JaxEvaluator(variables=jax_variables(jax_model_zoo(), x))
            with pytest.raises(TypeError) as want:
                ev.eval()
    with pytest.raises(TypeError) as got:
        eval_tool.main(["--config-file", str(yaml), *OPTS, *port_synthetic], device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["missing", "missing best", "empty path"])
def test_checkpoint_errors(port_synthetic, tmp_path, case):
    empty = str(tmp_path / "none")
    argv = ["--config-file", FLAGSHIP, *OPTS, *port_synthetic,
            "TEST.TEST_MODEL_PATH", "" if case == "empty path" else empty]
    if case == "missing best":
        argv.insert(0, "--best")
    if case == "empty path":
        evaluator = eval_tool.main(argv, device="cpu")
        logs = [p.read_text() for p in tmp_path.rglob("*.txt")]  # the run's log file
        assert any("evaluating randomly-initialised model" in text for text in logs)
        assert evaluator.metric.confusion_matrix.sum() == N_IMAGES * IMAGE_SIZE[0] * IMAGE_SIZE[1]
        return
    match = "No best checkpoint" if case == "missing best" else "No checkpoint found"
    with pytest.raises(FileNotFoundError, match=match):
        eval_tool.main(argv, device="cpu")
