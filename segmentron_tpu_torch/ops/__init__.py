from .pool import global_avg_pool
from .preprocess import maybe_normalize, normalize_u8
from .quant import bn_folded_affine
from .resize import resize_bilinear

__all__ = [
    "bn_folded_affine",
    "global_avg_pool",
    "maybe_normalize",
    "normalize_u8",
    "resize_bilinear",
]
