from .evaluator import Evaluator
from .steps import make_predict_fn

__all__ = ["Evaluator", "make_predict_fn"]
