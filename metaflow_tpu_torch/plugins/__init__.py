"""Plugin registries (reference shape: metaflow/plugins/__init__.py *_DESC
lists). Decorator classes register here; `--with name:attr=val` resolves
through STEP_DECORATORS.

The port's step decorators: @retry, @catch, @timeout, @environment,
@resources, @parallel, and the accelerator plugins @gpu (the counterpart of
the JAX package's @tpu), gpu_parallel (its tpu_parallel) and @checkpoint.
The JAX package's @pypi/@conda/@uv, @secrets and @card, and its flow
decorators (@project, @schedule, @trigger, @trigger_on_finish, @exit_hook)
are not in the port yet.
"""

from .core_decorators import (
    RetryDecorator,
    CatchDecorator,
    TimeoutDecorator,
    EnvironmentDecorator,
    ResourcesDecorator,
)
from .parallel_decorator import ParallelDecorator
from .gpu.gpu_decorator import GpuDecorator
from .gpu.gpu_parallel import GpuParallelDecorator
from .gpu.checkpoint_decorator import CheckpointDecorator

STEP_DECORATORS = {
    cls.name: cls
    for cls in (
        RetryDecorator,
        CatchDecorator,
        TimeoutDecorator,
        EnvironmentDecorator,
        ResourcesDecorator,
        ParallelDecorator,
        GpuDecorator,
        GpuParallelDecorator,
        CheckpointDecorator,
    )
}

FLOW_DECORATORS = {}


def register_step_decorator(cls):
    STEP_DECORATORS[cls.name] = cls
    return cls


def register_flow_decorator(cls):
    FLOW_DECORATORS[cls.name] = cls
    return cls
