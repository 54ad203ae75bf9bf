"""Command-line tools of the port (counterparts of the JAX package's
``tools/``): ``python3 -m segmentron_tpu_torch.tools.<name>``."""
