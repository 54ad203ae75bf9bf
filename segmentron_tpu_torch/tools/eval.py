"""Evaluation entry point (counterpart of the JAX package's ``tools/eval.py``).

    python -m segmentron_tpu_torch.tools.eval \
        --config-file configs/cityscapes_deeplabv3_plus_xception65.yaml [--best] \
        TEST.TEST_MODEL_PATH <snapshot directory> [KEY VALUE ...]

Runs on the CUDA device; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from ..config import cfg
from ..engine import Evaluator
from ..utils.default_setup import default_setup
from ..utils.options import parse_args

__all__ = ["main"]


def main(argv=None, device=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), set up the run and
    evaluate; returns the ``Evaluator`` after its ``eval()``."""
    args = parse_args(argv)
    if args.config_file:
        cfg.update_from_file(args.config_file)
    cfg.update_from_list(args.opts or [])
    cfg.PHASE = "test"
    default_setup(args)
    evaluator = Evaluator(device=device, args=args)
    evaluator.eval()
    return evaluator


if __name__ == "__main__":
    main()
