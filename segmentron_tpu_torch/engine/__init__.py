from .evaluator import Evaluator
from .steps import make_predict_fn, make_train_step

__all__ = ["Evaluator", "make_predict_fn", "make_train_step"]
