"""PyTorch/CUDA port of metaflow_tpu, for NVIDIA Hopper: a workflow
framework with Metaflow's capabilities whose compute layer is PyTorch with
hand-written CUDA kernels.

Imports torch and never jax, and nothing of the JAX package `metaflow_tpu`,
which stays the reference. Entry points run on the CUDA device unless the
caller passes device="cpu"; without a card they raise.

Public API (the JAX package's, with @gpu for its @tpu):

    from metaflow_tpu_torch import FlowSpec, step, Parameter, JSONType, current
    from metaflow_tpu_torch import retry, catch, timeout, resources, environment
    from metaflow_tpu_torch import gpu, checkpoint, parallel
    from metaflow_tpu_torch import Flow, Run, Step, Task, DataArtifact, namespace

The compute layer (`inference`, `models`, `ops`, `serving`, `training`) is
imported on first use (`from metaflow_tpu_torch import training`), so a
flow that does not touch it does not pay for torch's import.
"""

from .flowspec import FlowSpec, step
from .parameters import Parameter, JSONType
from .current import current
from .exception import TpuFlowException, MetaflowException
from .unbounded_foreach import UnboundedForeachInput
from .decorators import make_step_decorator, make_flow_decorator
from .plugins import STEP_DECORATORS, FLOW_DECORATORS
from .client import (
    Metaflow,
    Flow,
    Run,
    Step,
    Task,
    DataArtifact,
    namespace,
    get_namespace,
    default_namespace,
)

__version__ = "0.1.0"

# cache keyed by (name, class) so wrapper identity is stable while the
# registry entry is unchanged
_deco_cache = {}

_COMPUTE = ("inference", "models", "ops", "serving", "training")


def __getattr__(name):
    # user-facing decorator callables (retry, catch, gpu, ...) resolve
    # lazily from the live registries, so `from metaflow_tpu_torch import
    # retry` and `--with retry` always agree
    if name in STEP_DECORATORS:
        key = (name, STEP_DECORATORS[name])
        if key not in _deco_cache:
            _deco_cache[key] = make_step_decorator(STEP_DECORATORS[name])
        return _deco_cache[key]
    if name in FLOW_DECORATORS:
        key = (name, FLOW_DECORATORS[name])
        if key not in _deco_cache:
            _deco_cache[key] = make_flow_decorator(FLOW_DECORATORS[name])
        return _deco_cache[key]
    if name in _COMPUTE:
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(
        "module 'metaflow_tpu_torch' has no attribute %r" % name)


__all__ = [
    "FlowSpec",
    "step",
    "Parameter",
    "JSONType",
    "current",
    "TpuFlowException",
    "MetaflowException",
    "UnboundedForeachInput",
    "retry",
    "catch",
    "timeout",
    "environment",
    "resources",
    "parallel",
    "gpu",
    "gpu_parallel",
    "checkpoint",
    "Metaflow",
    "Flow",
    "Run",
    "Step",
    "Task",
    "DataArtifact",
    "namespace",
    "get_namespace",
    "default_namespace",
    "inference",
    "models",
    "ops",
    "serving",
    "training",
]
