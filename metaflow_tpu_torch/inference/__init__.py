from .decode import (
    bucket_length,
    decode_forward,
    generate,
    init_kv_cache,
    make_generator,
    pad_to_bucket,
)
from .loading import load_run_checkpoint

__all__ = [
    "bucket_length",
    "decode_forward",
    "generate",
    "init_kv_cache",
    "make_generator",
    "pad_to_bucket",
    "load_run_checkpoint",
]
