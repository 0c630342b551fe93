from .norms import rms_norm, layer_norm
from .rope import rope_frequencies, apply_rope
from .attention import (attention, flash_attention, flash_block_bwd,
                        flash_block_fwd, reference_attention)
from .gmm import gather_rows, gmm, make_group_layout, scatter_rows
from .ring_attention import LocalRing, ProcessGroupRing, ring_attention
from .ulysses_attention import ulysses_attention

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope_frequencies",
    "apply_rope",
    "attention",
    "flash_attention",
    "flash_block_bwd",
    "flash_block_fwd",
    "ring_attention",
    "ulysses_attention",
    "LocalRing",
    "ProcessGroupRing",
    "reference_attention",
    "gmm",
    "make_group_layout",
    "scatter_rows",
    "gather_rows",
]

# Every TPU kernel of the JAX package (each function that reaches
# pl.pallas_call) and where the port stands on it. A ported kernel names its
# route and source; its launches are counted in launches.LAUNCHES under the
# same name. The JAX package is frozen, so the file:line references hold.
KERNELS = [
    {"name": "flash_fwd", "replaces": "metaflow_tpu/ops/attention.py:123",
     "route": "cuda", "source": "metaflow_tpu_torch/ops/csrc/flash_fwd.cu"},
    {"name": "flash_bwd_dq", "replaces": "metaflow_tpu/ops/attention.py:208",
     "route": "cuda", "source": "metaflow_tpu_torch/ops/csrc/flash_bwd.cu"},
    {"name": "flash_bwd_dkv",
     "replaces": "metaflow_tpu/ops/attention.py:247",
     "route": "cuda", "source": "metaflow_tpu_torch/ops/csrc/flash_bwd.cu"},
    {"name": "flash_block_fwd",
     "replaces": "metaflow_tpu/ops/attention.py:395",
     "route": "cuda", "source": "metaflow_tpu_torch/ops/csrc/flash_fwd.cu"},
    {"name": "gmm_fwd", "replaces": "metaflow_tpu/ops/gmm.py:149",
     "route": "cuda", "source": "metaflow_tpu_torch/ops/csrc/gmm.cu"},
    {"name": "gmm_dw", "replaces": "metaflow_tpu/ops/gmm.py:200",
     "route": "cuda", "source": "metaflow_tpu_torch/ops/csrc/gmm.cu"},
]
