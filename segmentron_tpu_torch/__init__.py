"""PyTorch/CUDA port of ``segmentron_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this package is held
against; nothing here imports it or JAX. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
