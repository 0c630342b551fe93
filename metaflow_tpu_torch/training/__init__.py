from .checkpoint import AsyncCheckpointManager, Checkpoint
from .data import ResumableTokenBatches, prefetch, token_batches
from .metrics import flops_per_token_dense, peak_tflops
from .train_step import (
    Adafactor,
    AdamW,
    check_opt_state,
    default_optimizer,
    factored_dims,
    make_eval_step,
    make_train_state,
    make_train_step,
    make_trainer,
    memory_efficient_optimizer,
)

__all__ = [
    "Adafactor",
    "AdamW",
    "AsyncCheckpointManager",
    "Checkpoint",
    "ResumableTokenBatches",
    "check_opt_state",
    "default_optimizer",
    "factored_dims",
    "flops_per_token_dense",
    "make_eval_step",
    "make_train_state",
    "make_train_step",
    "make_trainer",
    "memory_efficient_optimizer",
    "peak_tflops",
    "prefetch",
    "token_batches",
]
