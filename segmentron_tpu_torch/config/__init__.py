from .config import SegmentronConfig
from .settings import cfg

__all__ = ["SegmentronConfig", "cfg"]
