"""Training entry point (counterpart of the JAX package's ``tools/train.py``).

    python -m segmentron_tpu_torch.tools.train \
        --config-file configs/cityscapes_deeplabv3_plus_xception65.yaml [KEY VALUE ...]

Runs on the CUDA device; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from ..config import cfg
from ..engine import Trainer
from ..utils.default_setup import default_setup
from ..utils.options import parse_args

__all__ = ["main"]


def main(argv=None, device=None) -> float:
    """Parse ``argv`` (default ``sys.argv[1:]``), set up the run and
    train; returns the last epoch's loss."""
    args = parse_args(argv)
    if args.config_file:
        cfg.update_from_file(args.config_file)
    cfg.update_from_list(args.opts or [])
    cfg.PHASE = "train"
    seed = default_setup(args)
    return Trainer(args, seed=seed, device=device).train()


if __name__ == "__main__":
    main()
