"""Multi-process bootstrap: the gang's torch.distributed group.

The JAX package joins `jax.distributed` from a gang's rendezvous; the
port's gang steps join a torch.distributed process group
(plugins/gpu/gpu_parallel.py `init_gang`). These are the JAX package's
entry points over that group.
"""

import os


def initialize_from_current():
    """Call inside a gang (@parallel/num_parallel) step to join the gang's
    process group. No-op for single-node gangs or when a group exists
    (the gang's decorator has usually joined it already). Returns whether
    this call joined one."""
    import torch.distributed as dist

    from ..current import current

    p = getattr(current, "parallel", None)
    if p is None or p.num_nodes <= 1 or dist.is_initialized():
        return False
    from .. import telemetry
    from ..plugins.gpu.gpu_parallel import init_gang

    with telemetry.timer(
        "distributed.initialize",
        data={"num_nodes": p.num_nodes, "node_index": p.node_index},
    ):
        init_gang(p)
    telemetry.event("distributed.initialized", data=process_info())
    return True


def initialize_from_env():
    """Join the group torchrun-style launchers describe in the environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE). No-op when a group
    exists."""
    import torch
    import torch.distributed as dist

    from .. import telemetry

    if dist.is_initialized():
        return False
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    with telemetry.timer("distributed.initialize", data={"source": "env"}):
        dist.init_process_group(backend=backend, init_method="env://")
    return True


def ensure_group(device):
    """The default process group, made here as a group of this one rank
    when none exists: NCCL (and gloo for CPU tensors) for a CUDA device,
    gloo for the CPU. A DeviceMesh needs a default group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, store=dist.HashStore(),
                            rank=0, world_size=1)
    return True


def process_info():
    """This rank's index, the group's size and the devices: each rank
    drives one device (its card, or the CPU)."""
    import torch.distributed as dist

    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }
