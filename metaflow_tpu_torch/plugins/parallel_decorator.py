"""@parallel: gang-scheduled steps (`self.next(step, num_parallel=N)`), the
JAX package's plugins/parallel_decorator.py.

Reference behavior: metaflow/plugins/parallel_decorator.py — the scheduler
queues ONE control task (UBF_CONTROL); locally the control task forks N-1
worker `step` subprocesses (task ids `{control}_node_i`), runs rank 0 itself,
then waits; `current.parallel` is wired from MF_PARALLEL_* env vars; framework
subclasses override `setup_distributed_env`.

The GpuParallelDecorator subclass (plugins/gpu) initializes a
`torch.distributed` process group from `current.parallel`, so each gang
member becomes one rank (gloo for CPU tensors, and NCCL for CUDA tensors
where a card is visible).
"""

import json
import os
import subprocess
import sys

from .. import knobs, telemetry, tracing
from ..current import current, Parallel
from ..decorators import StepDecorator
from ..exception import TpuFlowException
from ..metadata.metadata import MetaDatum
from ..unbounded_foreach import UBF_CONTROL, UBF_TASK


class ParallelDecorator(StepDecorator):
    name = "parallel"
    defaults = {}
    # framework subclasses can require a coordinator port
    COORDINATOR_PORT = 9379

    def runtime_step_cli(self, cli_args, retry_count, max_user_code_retries,
                         ubf_context):
        if ubf_context == UBF_CONTROL:
            cli_args.command_options["ubf-context"] = UBF_CONTROL

    def task_pre_step(self, step_name, task_datastore, metadata, run_id,
                      task_id, flow, graph, retry_count, max_user_code_retries,
                      ubf_context, inputs):
        self._metadata = metadata
        self._run_id = run_id
        self._step_name = step_name
        self._task_id = task_id
        self._flow_datastore = task_datastore._flow_datastore
        num_nodes = int(os.environ.get("MF_PARALLEL_NUM_NODES", "1"))
        node_index = int(os.environ.get("MF_PARALLEL_NODE_INDEX", "0"))
        main_ip = os.environ.get("MF_PARALLEL_MAIN_IP", "127.0.0.1")
        control_task_id = os.environ.get("MF_PARALLEL_CONTROL_TASK_ID", task_id)
        port = int(
            os.environ.get("MF_PARALLEL_COORDINATOR_PORT", self.COORDINATOR_PORT)
        )
        current._update_env(
            {
                "parallel": Parallel(
                    main_ip=main_ip,
                    num_nodes=num_nodes,
                    node_index=node_index,
                    control_task_id=control_task_id,
                    coordinator_port=port,
                )
            }
        )

    def setup_distributed_env(self, flow):
        """Hook for framework subclasses (e.g. a torch.distributed process
        group, plugins/gpu/gpu_parallel.py)."""
        pass

    def teardown_distributed_env(self, flow):
        pass

    def task_decorate(self, step_func, flow, graph, retry_count,
                      max_user_code_retries, ubf_context):
        # Two externally-launched rank modes (the launcher starts one
        # process per rank, so the control task must NOT fork):
        #   MF_PARALLEL_REMOTE=1    the launcher's own rendezvous
        #   MF_PARALLEL_EXTERNAL=1  explicit rendezvous from MF_PARALLEL_*
        #                           (coordinator addr/port env)
        external = (
            os.environ.get("MF_PARALLEL_REMOTE", "0") == "1"
            or os.environ.get("MF_PARALLEL_EXTERNAL", "0") == "1"
        )
        if ubf_context == UBF_CONTROL and not external:
            # local gang: the control task is responsible for forking the
            # workers, running rank 0 itself, and reaping the children
            return lambda: self._local_multinode_control_task_step_func(
                flow, graph, step_func, retry_count
            )

        def wrapped():
            if ubf_context == UBF_CONTROL:
                # rank 0 of an external gang: record the membership the
                # join and _finalize_control_task need (the local fork
                # path does this after forking; external launchers derive
                # task ids instead of assigning them, so the contract is
                # reconstructed here)
                self._register_external_gang(flow)
            self.setup_distributed_env(flow)
            try:
                step_func()
            finally:
                self.teardown_distributed_env(flow)

        wrapped.__name__ = step_func.__name__
        return wrapped

    def _register_external_gang(self, flow):
        """Record _control_mapper_tasks for an externally-launched gang:
        worker task ids follow the same `{control}-node-{i}` naming the
        local fork path and every launcher use."""
        num_nodes = int(os.environ.get("MF_PARALLEL_NUM_NODES", "1"))
        control_task_id = str(self._task_id)
        mapper_task_ids = [control_task_id] + [
            "%s-node-%d" % (control_task_id, i)
            for i in range(1, num_nodes)
        ]
        flow._control_mapper_tasks = [
            "/".join((self._run_id, self._step_name, task_id))
            for task_id in mapper_task_ids
        ]
        self._metadata.register_metadata(
            self._run_id,
            self._step_name,
            control_task_id,
            [
                MetaDatum(
                    "control-mapper-tasks",
                    json.dumps(flow._control_mapper_tasks),
                    "control-mapper-tasks",
                    [],
                )
            ],
        )

    def _local_multinode_control_task_step_func(self, flow, graph, step_func,
                                                retry_count):
        """Fork N-1 local `step` subprocesses, run rank 0 in-process, wait.

        Reference: parallel_decorator.py:_local_multinode_control_task_step_func
        :175-246. Each rank is an OS process; rank 0 hosts the process
        group's rendezvous.
        """
        from ..cli import STEP_ARGV_ENV

        num_parallel = int(flow._foreach_num_splits or 1)
        run_id = current.run_id
        step_name = current.step_name
        control_task_id = current.task_id

        os.environ["MF_PARALLEL_MAIN_IP"] = "127.0.0.1"
        os.environ["MF_PARALLEL_NUM_NODES"] = str(num_parallel)
        os.environ["MF_PARALLEL_CONTROL_TASK_ID"] = str(control_task_id)
        os.environ.setdefault(
            "MF_PARALLEL_COORDINATOR_PORT", str(self._free_port())
        )

        # worker argv: replay this process's own step command with a new
        # task-id and ubf context (recorded by the CLI in the environment);
        # sys.argv[0] is the flow .py file, so prepend the interpreter
        base_argv = json.loads(os.environ[STEP_ARGV_ENV])
        if base_argv and base_argv[0].endswith(".py"):
            base_argv = [sys.executable] + base_argv

        from ..util import preexec_die_with_parent

        rank_preexec = preexec_die_with_parent(os.getpid())
        # each rank runs under the mflog_capture supervisor: its
        # stdout/stderr persist into ITS OWN task datastore (readable via
        # the client and the logs command) while still teeing through to
        # this console.
        fds = self._flow_datastore
        capture_prefix = [
            sys.executable, "-m", "metaflow_tpu_torch.mflog_capture",
            "--flow-name", flow.name, "--run-id", str(run_id),
            "--step", step_name, "--attempt", str(retry_count),
            "--datastore", fds.ds_type,
        ]
        if fds.ds_root:
            capture_prefix += ["--datastore-root", fds.ds_root]
        mapper_task_ids = [str(control_task_id)]
        procs = []
        for node_index in range(1, num_parallel):
            task_id = "%s-node-%d" % (control_task_id, node_index)
            mapper_task_ids.append(task_id)
            argv = list(base_argv)
            argv = self._replace_opt(argv, "--task-id", task_id)
            argv = self._replace_opt(argv, "--split-index", str(node_index))
            argv = self._replace_opt(argv, "--ubf-context", UBF_TASK)
            env = dict(os.environ)
            env["MF_PARALLEL_NODE_INDEX"] = str(node_index)
            # trace context propagates into every rank: OTel spans (and
            # flight-recorder records) from all gang workers join the
            # control task's trace
            tracing.inject_tracing_vars(env)
            procs.append(
                subprocess.Popen(
                    capture_prefix + ["--task-id", task_id, "--"] + argv,
                    env=env,
                    stdout=sys.stdout,
                    stderr=sys.stderr,
                    # SIGKILLed control task ⇒ kernel reaps the capture
                    # supervisor, whose own PDEATHSIG reaps the rank (a
                    # rank wedged in a collective outlives any
                    # Python-level cleanup)
                    preexec_fn=rank_preexec,
                )
            )

        # record the gang membership so the join sees all N tasks
        flow._control_mapper_tasks = [
            "/".join((run_id, step_name, task_id)) for task_id in mapper_task_ids
        ]
        telemetry.event(
            "gang.spawned",
            data={"num_parallel": num_parallel,
                  "worker_tasks": mapper_task_ids[1:]})
        self._metadata.register_metadata(
            run_id,
            step_name,
            control_task_id,
            [
                MetaDatum(
                    "control-mapper-tasks",
                    json.dumps(flow._control_mapper_tasks),
                    "control-mapper-tasks",
                    [],
                )
            ],
        )

        # rank 0 runs in-process
        os.environ["MF_PARALLEL_NODE_INDEX"] = "0"
        current._update_env(
            {
                "parallel": Parallel(
                    main_ip="127.0.0.1",
                    num_nodes=num_parallel,
                    node_index=0,
                    control_task_id=str(control_task_id),
                    coordinator_port=int(
                        os.environ["MF_PARALLEL_COORDINATOR_PORT"]
                    ),
                )
            }
        )
        # watch workers WHILE rank 0 runs: a worker dying mid-step (e.g.
        # preempted) must fail the gang promptly, not after rank 0 finishes
        # a step that may be blocked on the dead peer. SIGUSR1 raises in
        # rank 0's main thread at the next bytecode boundary.
        import signal as _signal
        import threading as _threading

        watcher_stop = _threading.Event()
        early_failed = []

        def _on_worker_failure(signum, frame):
            exc = TpuFlowException(
                "Gang worker task(s) failed mid-step: %s"
                % ", ".join(early_failed)
            )
            # route through the preemption handler so a shield()ed critical
            # section (checkpoint save) is never interrupted mid-write
            handler = getattr(current, "preemption", None)
            if handler is not None:
                handler.deliver(exc)
            else:
                raise exc

        prev_usr1 = _signal.signal(_signal.SIGUSR1, _on_worker_failure)

        def _watch():
            main_pid = os.getpid()
            while not watcher_stop.wait(0.2):
                for proc, task_id in zip(procs, mapper_task_ids[1:]):
                    rc = proc.poll()
                    if rc is not None and rc != 0:
                        early_failed.append(task_id)
                        os.kill(main_pid, _signal.SIGUSR1)
                        return

        watcher = _threading.Thread(target=_watch, daemon=True)
        watcher.start()

        try:
            self.setup_distributed_env(flow)
            try:
                step_func()
            finally:
                self.teardown_distributed_env(flow)

            watcher_stop.set()
            watcher.join(timeout=5)
            failed = []
            # TPUFLOW_GANG_NODE_WAIT_TIMEOUT_S bounds how long the
            # control rank waits for each worker to exit (0 = forever).
            # Without it a wedged worker parks the control here with a
            # live heartbeat — the exact shape the gang watchdog exists
            # to break; the bound is the belt-and-suspenders fallback
            # (and the bench's "undetected hang" baseline).
            wait_s = knobs.get_float("TPUFLOW_GANG_NODE_WAIT_TIMEOUT_S")
            for proc, task_id in zip(procs, mapper_task_ids[1:]):
                try:
                    rc = proc.wait(timeout=wait_s if wait_s > 0 else None)
                except subprocess.TimeoutExpired:
                    # reap every still-running worker before failing the
                    # attempt: a wedged rank must not outlive its gang as
                    # a sleeping orphan
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    raise TpuFlowException(
                        "Gang worker task %s did not exit within %.0fs of "
                        "the control rank finishing its step — presumed "
                        "hung" % (task_id, wait_s)
                    )
                if rc != 0:
                    failed.append(task_id)
            if failed:
                raise TpuFlowException(
                    "Gang worker task(s) failed: %s" % ", ".join(failed)
                )
        except BaseException:
            # rank 0 died (or a watched worker failed): never leave worker
            # ranks running (a stalled rank would hold collective state —
            # and its card)
            watcher_stop.set()
            for proc in procs:
                if proc.poll() is None:
                    proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=10)
                except Exception:
                    proc.kill()
            raise
        finally:
            watcher_stop.set()
            _signal.signal(_signal.SIGUSR1, prev_usr1)

    @staticmethod
    def _free_port():
        import socket

        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    @staticmethod
    def _replace_opt(argv, opt, value):
        argv = list(argv)
        for i, a in enumerate(argv):
            if a == opt and i + 1 < len(argv):
                argv[i + 1] = value
                return argv
            if a.startswith(opt + "="):
                argv[i] = "%s=%s" % (opt, value)
                return argv
        argv.extend([opt, value])
        return argv
