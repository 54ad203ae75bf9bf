from .evaluator import Evaluator
from .steps import make_eval_step, make_predict_fn, make_train_step
from .trainer import Trainer

__all__ = ["Evaluator", "Trainer", "make_eval_step", "make_predict_fn", "make_train_step"]
