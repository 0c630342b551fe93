from .gpu_decorator import GpuDecorator
from .gpu_parallel import GpuParallelDecorator
from .checkpoint_decorator import CheckpointDecorator

__all__ = ["GpuDecorator", "GpuParallelDecorator", "CheckpointDecorator"]
