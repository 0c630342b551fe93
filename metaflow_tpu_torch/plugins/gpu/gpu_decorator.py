"""@gpu: run a step on the GPU; the port's counterpart of the JAX package's
@tpu compute decorator (plugins/tpu/tpu_decorator.py).

  - `@gpu` on a step declares that it runs on the cards of the host the
    task lands on, and exposes `current.gpu` (number and kind of the cards,
    the declared topology and mesh axes).
  - `require_gpu=True` fails the step when no card is attached, instead of
    letting it run on the CPU.
  - For gang steps (num_parallel), the auto-attached GpuParallelDecorator
    makes the ranks one torch.distributed process group (NCCL for the
    CUDA tensors, gloo for the CPU ones).
  - Like @tpu, it rewrites the task's command line (`runtime_step_cli`),
    so the runtime launches a @gpu step by exec and never by fork: the
    scheduler's process must not hand a task any inherited state, and a
    CUDA context cannot cross fork.

The TPU-VM launcher trampoline (TPUFLOW_TPU_LAUNCHER) and the TPU
topologies' host counts are TPU-only: with TPUFLOW_TPU_LAUNCHER set, the
decorator raises.
"""

import os

from ... import knobs
from ...current import current
from ...decorators import StepDecorator
from ...exception import TpuFlowException


class GpuInfo(object):
    """Exposed as `current.gpu`."""

    def __init__(self, topology, num_devices, device_kind, mesh_axes):
        self.topology = topology
        self.num_devices = num_devices
        self.device_kind = device_kind
        self.mesh_axes = mesh_axes

    def __repr__(self):
        return "GpuInfo(topology=%r, num_devices=%d, kind=%r)" % (
            self.topology,
            self.num_devices,
            self.device_kind,
        )


def _refuse_launcher():
    if knobs.get_str("TPUFLOW_TPU_LAUNCHER"):
        raise TpuFlowException(
            "TPUFLOW_TPU_LAUNCHER is set, but @gpu steps have no remote "
            "launcher: the TPU-VM launcher trampoline is TPU-only. Unset "
            "it to run the step on this host's cards.")


class GpuDecorator(StepDecorator):
    """@gpu(topology=None, mesh=None, require_gpu=False, spot=False)

    topology: a free-form label of the cards the step expects (e.g.
    '1xH100'), exposed as current.gpu.topology.
    mesh: optional dict of mesh axis sizes, e.g. {'data': 2, 'model': 4},
    exposed as current.gpu.mesh_axes.
    spot: start the preemption-monitor sidecar (a spot reclaim notice
    becomes SIGTERM, then a retryable TaskPreempted).
    """

    name = "gpu"
    defaults = {
        "topology": None,
        "mesh": None,
        "require_gpu": False,
        "spot": False,
    }

    def runtime_init(self, flow, graph, package, run_id):
        _refuse_launcher()

    def runtime_step_cli(self, cli_args, retry_count, max_user_code_retries,
                         ubf_context):
        # overriding this hook is what makes the runtime exec the task
        _refuse_launcher()

    def task_pre_step(self, step_name, task_datastore, metadata, run_id,
                      task_id, flow, graph, retry_count, max_user_code_retries,
                      ubf_context, inputs):
        import torch

        num_devices = torch.cuda.device_count()
        if self.attributes["require_gpu"] and num_devices == 0:
            raise TpuFlowException(
                "@gpu(require_gpu=True) on step *%s* but no GPU devices are "
                "attached (found: cpu)." % step_name
            )
        current._update_env(
            {
                "gpu": GpuInfo(
                    topology=self.attributes["topology"],
                    num_devices=num_devices,
                    device_kind=torch.cuda.get_device_name(0)
                    if num_devices else "none",
                    mesh_axes=self.attributes["mesh"],
                )
            }
        )
        self._spot_monitor = None
        if self.attributes["spot"] or knobs.is_set(
            "TPUFLOW_SPOT_METADATA_URL"
        ):
            import subprocess
            import sys

            args = [sys.executable, "-m",
                    "metaflow_tpu_torch.plugins.gpu.preemption",
                    "--task-pid", str(os.getpid())]
            url = knobs.get_raw("TPUFLOW_SPOT_METADATA_URL")
            if url:
                args += ["--metadata-url", url]
            self._spot_monitor = subprocess.Popen(args)

    def task_finished(self, step_name, flow, graph, is_task_ok, retry_count,
                      max_user_code_retries):
        monitor = getattr(self, "_spot_monitor", None)
        if monitor is not None and monitor.poll() is None:
            monitor.terminate()
            try:
                monitor.wait(timeout=5)
            except Exception:
                monitor.kill()
