"""PyTorch/CUDA port of metaflow_tpu's compute layer, for NVIDIA Hopper.

Imports torch and never jax, and nothing of the JAX package `metaflow_tpu`,
which stays the reference. Entry points run on the CUDA device unless the
caller passes device="cpu"; without a card they raise.
"""

from . import inference, models, ops, serving, training

__all__ = ["inference", "models", "ops", "serving", "training"]
