from .metrics import flops_per_token_dense, peak_tflops
from .train_step import (
    AdamW,
    check_opt_state,
    default_optimizer,
    make_eval_step,
    make_train_state,
    make_train_step,
    make_trainer,
)

__all__ = [
    "AdamW",
    "check_opt_state",
    "default_optimizer",
    "flops_per_token_dense",
    "make_eval_step",
    "make_train_state",
    "make_train_step",
    "make_trainer",
    "peak_tflops",
]
