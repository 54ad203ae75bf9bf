"""How far ``TPU.INT8_RESNET`` moves the argmax of DANet and OCNet over
ResNet-101 at output stride 8, full width and depth, in both packages on
the CPU, on the weights ``chip_smoke.py`` phase 9 gives them (the port's
seeded init, BN statistics drawn as in phase 6, ``gamma`` 0.5) carried
into the JAX package's variables, at a cut image size.

    python tests/int8_agreement.py [H W]     (default 256 512)

Prints one JSON line a model: the JAX package's own int8-vs-f32 argmax
agreement and mean|d logit|, the port's int8-vs-f32 and int8-vs-bf16
agreement, and the port's int8 logits against the JAX package's. Phase 9
(b) holds the card's int8-vs-bf16 agreement at 1024x2048 to the JAX
package's int8-vs-f32 agreement here, less ``chip_smoke.INT8_AGREE_MARGIN``.
Not a test (pytest collects ``test_*.py`` only): it runs two ResNet-101
models in both packages, minutes on the CPU.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from segmentron_tpu.config import cfg as jax_cfg  # noqa: E402
from segmentron_tpu.models import get_segmentation_model as jax_model_zoo  # noqa: E402
from segmentron_tpu_torch.config import cfg as port_cfg  # noqa: E402
from segmentron_tpu_torch.data.dataloader import SyntheticSegmentation  # noqa: E402
from segmentron_tpu_torch.engine import make_predict_fn  # noqa: E402
from segmentron_tpu_torch.models.backbones.resnet import int8_resnet_k, set_int8_resnet  # noqa: E402
from segmentron_tpu_torch.ops import normalize_u8  # noqa: E402


def to_flax_variables(state, shapes):
    """The port's ``state_dict`` -> flax variables shaped as ``shapes`` (the
    inverse of ``utils/convert.py::from_flax_variables``)."""
    def fill(path, leaf):
        keys = [p.key for p in path]
        collection, scope, name = keys[0], ".".join(keys[1:-1]), keys[-1]
        if len(keys) == 2:  # a scalar parameter (gamma)
            value = state[name]
        elif name == "kernel":
            value = state[f"{scope}.weight"].permute(2, 3, 1, 0)
        elif collection == "batch_stats":
            value = state[f"{scope}.running_{'mean' if name == 'mean' else 'var'}"]
        else:
            value = state[f"{scope}.{'weight' if name == 'scale' else name}"]
        value = value.detach().float().numpy()
        assert value.shape == leaf.shape, (keys, value.shape, leaf.shape)
        return value

    return jax.tree_util.tree_map_with_path(fill, shapes)


def main(hw=(256, 512)):
    defaults = port_cfg.to_dict()
    image = SyntheticSegmentation(split="val", mode="testval", length=1, image_size=hw)[0][0]
    x = normalize_u8(torch.from_numpy(image[None]), port_cfg.DATASET.MEAN, port_cfg.DATASET.STD)
    for name, yaml in chip_smoke.ATTENTION_MODELS.items():
        chip_smoke.load_cfg(port_cfg, defaults, os.path.join(ROOT, yaml), chip_smoke.SERVE_OPTS)
        model, _ = chip_smoke.attention_model(torch, "cpu", port_cfg)
        state = model.state_dict()
        logits = {}
        for dtype in ("float32", "bfloat16"):
            predict = make_predict_fn(model, dtype, "cpu")
            for int8 in (True, False):
                set_int8_resnet(model, int8_resnet_k(port_cfg) if int8 else None)
                logits[("port", dtype, int8)] = predict(x).numpy()

        jax_cfg.update_from_file(os.path.join(ROOT, yaml))
        jax_cfg.update_from_list(["DATASET.NAME", "synthetic", "TPU.COMPUTE_DTYPE", "float32"])
        jax_model = jax_model_zoo()
        xn = x.numpy()
        shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), xn, False))
        variables = to_flax_variables(state, shapes)
        for int8 in (True, False):
            jax_cfg.TPU.INT8_RESNET = int8
            fwd = jax.jit(lambda v, x: jax_model.apply(v, x, False)[0])
            logits[("jax", "float32", int8)] = np.asarray(fwd(variables, xn))

        def agree(a, b):
            return float((logits[a].argmax(-1) == logits[b].argmax(-1)).mean())

        def mean_d(a, b):
            return float(np.abs(logits[a] - logits[b]).mean())

        jax8, jax32 = ("jax", "float32", True), ("jax", "float32", False)
        print(json.dumps({
            "model": name, "hw": list(hw),
            "jax_int8_vs_f32": agree(jax8, jax32), "jax_mean_d_int8_vs_f32": mean_d(jax8, jax32),
            "port_int8_vs_f32": agree(("port", "float32", True), ("port", "float32", False)),
            "port_int8_vs_bf16": agree(("port", "bfloat16", True), ("port", "bfloat16", False)),
            "port_int8_vs_jax_int8": agree(("port", "float32", True), jax8),
            "port_mean_d_int8_vs_jax_int8": mean_d(("port", "float32", True), jax8),
            "port_f32_vs_jax_f32_max_d": float(np.abs(logits[("port", "float32", False)]
                                                      - logits[jax32]).max()),
        }), flush=True)


if __name__ == "__main__":
    main(tuple(int(v) for v in sys.argv[1:3]) if len(sys.argv) > 2 else (256, 512))
