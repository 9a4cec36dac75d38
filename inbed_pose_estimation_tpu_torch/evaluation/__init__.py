from .evaluate import mask_confusion, run_evaluation
from .pipeline import eval_metrics, load_j_regressor_h36m, make_forward_fn, make_inference_fn, regress_j17

__all__ = ["eval_metrics", "load_j_regressor_h36m", "make_forward_fn", "make_inference_fn", "mask_confusion",
           "regress_j17", "run_evaluation"]
