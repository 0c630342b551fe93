from ..data import StreamingTokenBatches
from .checkpoint import AsyncCheckpointManager, Checkpoint
from .data import STATE_KEY, ResumableTokenBatches, prefetch, token_batches
from .metrics import (
    TrainStepTelemetry,
    flops_per_token_dense,
    hbm_gbps,
    instrument_train_step,
    peak_tflops,
)
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
    "STATE_KEY",
    "StreamingTokenBatches",
    "TrainStepTelemetry",
    "check_opt_state",
    "default_optimizer",
    "factored_dims",
    "flops_per_token_dense",
    "hbm_gbps",
    "instrument_train_step",
    "make_eval_step",
    "make_train_state",
    "make_train_step",
    "make_trainer",
    "memory_efficient_optimizer",
    "peak_tflops",
    "prefetch",
    "token_batches",
]
