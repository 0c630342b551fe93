"""GpuParallelDecorator: gang steps become one torch.distributed process
group; the port's counterpart of the JAX package's TpuParallelDecorator
(plugins/tpu/tpu_parallel.py), which calls `jax.distributed.initialize`.

The CLI attaches it to every gang step (`self.next(step,
num_parallel=N)`) that has no @parallel decorator of its own. Each rank
calls `torch.distributed.init_process_group` with the rendezvous of
`current.parallel`: `tcp://main_ip:coordinator_port`, rank `node_index`,
world size `num_nodes`. The group is destroyed at teardown.

Each collective's backend follows the device of its tensors, not the
step's decorators: on a host with a card the group holds both NCCL (for
CUDA tensors) and gloo (for CPU tensors), `cpu:gloo,cuda:nccl`, and each
rank takes card `node_index % device_count`; on a host without one it
is gloo alone. So a @gpu step that keeps some tensors on the CPU, and a
step without @gpu that puts its tensors on the card, both reduce them
where they lie.

A gang step builds its mesh on this group: `create_mesh(MeshSpec.fsdp())`
(spmd/mesh.py) lays the gang's ranks out on the mesh's axes, one card
each; a gang of one node gets no group here, and create_mesh makes a
group of its one rank.
"""

from ..parallel_decorator import ParallelDecorator


def init_gang(p):
    """Join the process group of the gang `p` (a current.parallel): NCCL
    for CUDA tensors and gloo for CPU tensors where a card is visible,
    with card `node_index % device_count` this rank's current device;
    gloo alone where none is. Returns the backend."""
    import datetime

    import torch
    import torch.distributed as dist

    backend = "gloo"
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        torch.cuda.set_device(p.node_index % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method="tcp://%s:%d" % (p.main_ip, p.coordinator_port),
        rank=p.node_index,
        world_size=p.num_nodes,
        timeout=datetime.timedelta(minutes=10),
    )
    return backend


class GpuParallelDecorator(ParallelDecorator):
    name = "gpu_parallel"
    defaults = {}

    def setup_distributed_env(self, flow):
        from ...current import current

        if current.parallel.num_nodes <= 1:
            return
        init_gang(current.parallel)
        self._reinstall_preemption_handler()

    @staticmethod
    def _reinstall_preemption_handler():
        """Put the task's PreemptionHandler back on SIGTERM after the
        process group comes up (the JAX package does so because
        jax.distributed installs its own notifier), so a spot reclaim
        still raises TaskPreempted."""
        from ...current import current

        handler = getattr(current, "preemption", None)
        if handler is not None:
            handler._installed = False
            handler.install()

    def teardown_distributed_env(self, flow):
        """Destroy the step's group: the gang's, or the one-rank group a
        one-node gang's create_mesh made."""
        import sys

        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()
