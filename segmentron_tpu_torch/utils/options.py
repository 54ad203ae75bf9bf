"""Command-line arguments of the port's tools (counterpart of
``segmentron_tpu/utils/options.py::parse_args``)."""

from __future__ import annotations

import argparse

__all__ = ["parse_args"]


def parse_args(argv=None):
    """``--config-file``, ``--log-iter``, ``--val-epoch``, ``--skip-val``,
    ``--resume``, ``--best`` and the trailing ``KEY VALUE`` config
    overrides."""
    parser = argparse.ArgumentParser(description="SegmenTron (PyTorch/CUDA port)")
    parser.add_argument("--config-file", metavar="FILE", default=None, help="config file path")
    parser.add_argument("--log-iter", type=int, default=10, help="log every N iters")
    parser.add_argument("--val-epoch", type=int, default=1, help="run validation every N epochs")
    parser.add_argument("--skip-val", action="store_true", default=False, help="skip validation")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="resume from the latest snapshot")
    parser.add_argument("--best", action="store_true", default=False,
                        help="eval: restore the best-mIoU snapshot instead of the latest")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    return parser.parse_args(argv)
