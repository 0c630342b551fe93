"""Task executor: runs ONE attempt of ONE task in-process (the JAX
package's task.py).

Reference behavior: metaflow/task.py (MetaflowTask:38, run_step:570): datastore
init, foreach/input state, `current` setup, the decorator hook sequence around
the user step function, artifact persist + DONE marker, attempt_ok metadata.
Invoked by the runtime as a `step` subprocess (process isolation per task).
"""

import json
import sys
import time
import traceback

from . import knobs, telemetry
from .current import current
from .exception import TaskPreempted, TpuFlowException, MetaflowInternalError
from .metadata.metadata import MetaDatum
from .unbounded_foreach import UBF_CONTROL
from .util import get_username


class TaskFailedException(TpuFlowException):
    headline = "Step failure"


class InputDataStore(object):
    """Read-only artifact view over one input task, used as an element of the
    `inputs` argument of a join step (lazy attribute access)."""

    def __init__(self, task_datastore):
        object.__setattr__(self, "_datastore", task_datastore)
        object.__setattr__(self, "_cache", {})

    def __getattr__(self, name):
        cache = object.__getattribute__(self, "_cache")
        if name in cache:
            return cache[name]
        ds = object.__getattribute__(self, "_datastore")
        if name in ds:
            value = ds[name]
            cache[name] = value
            return value
        raise AttributeError(
            "Input from step *%s* has no artifact '%s'" % (ds.step_name, name)
        )

    def __contains__(self, name):
        return name in object.__getattribute__(self, "_datastore")

    def __repr__(self):
        return "<input %s>" % object.__getattribute__(self, "_datastore").pathspec


class Inputs(object):
    """The `inputs` object of a join step: index, iterate, or access by the
    originating step's name (static splits)."""

    def __init__(self, input_stores):
        self._inputs = input_stores

    def __getitem__(self, idx):
        return self._inputs[idx]

    def __iter__(self):
        return iter(self._inputs)

    def __len__(self):
        return len(self._inputs)

    def __getattr__(self, name):
        for inp in self._inputs:
            if object.__getattribute__(inp, "_datastore").step_name == name:
                return inp
        raise AttributeError("No input from step '%s'" % name)


class MetaflowTask(object):
    def __init__(
        self,
        flow,
        flow_datastore,
        metadata,
        environment=None,
        console_logger=None,
        event_logger=None,
        monitor=None,
        ubf_context=None,
    ):
        self.flow = flow
        self.flow_datastore = flow_datastore
        self.metadata = metadata
        self.environment = environment
        self.console_logger = console_logger or (lambda *a, **k: None)
        if event_logger is None or monitor is None:
            from .system import get_event_logger, get_monitor

            event_logger = event_logger or get_event_logger()
            monitor = monitor or get_monitor()
        self.event_logger = event_logger
        self.monitor = monitor
        self.ubf_context = ubf_context

    def _exec_step_function(self, step_function, orig_step_func, input_obj=None):
        if input_obj is None:
            step_function()
        else:
            step_function(input_obj)

    def _init_parameters(self, parameters_json):
        """Set parameter values as flow attributes (they persist as artifacts
        and propagate downstream automatically)."""
        names = []
        values = json.loads(parameters_json) if parameters_json else {}
        for name, param in self.flow._get_parameters():
            if name in values:
                value = param.convert(values[name])
            else:
                value = param.resolve_default()
                if value is None and param.is_required:
                    raise TpuFlowException(
                        "Parameter *%s* is required but no value was "
                        "provided." % name
                    )
            setattr(self.flow, name, value)
            names.append(name)
        self.flow._parameter_names = names
        return names

    def _init_foreach(self, step_name, input_ds, split_index, node):
        """Compute this task's foreach stack from its parent's."""
        flow = self.flow
        parent_type = None
        parent_stack = []
        if input_ds is not None and "_foreach_stack" in input_ds:
            parent_stack = list(input_ds["_foreach_stack"])

        if node.type == "join":
            # a join pops the innermost frame
            flow._foreach_stack = parent_stack[:-1] if parent_stack else []
            return

        if split_index is not None and input_ds is not None:
            # we are a child of a foreach/parallel split
            var = input_ds.get("_foreach_var")
            num_splits = input_ds.get("_foreach_num_splits")
            flow._foreach_stack = parent_stack + [
                (var, int(split_index), num_splits)
            ]
        else:
            flow._foreach_stack = parent_stack

    def run_step(
        self,
        step_name,
        run_id,
        task_id,
        origin_run_id=None,
        input_paths=None,
        split_index=None,
        retry_count=0,
        max_user_code_retries=0,
        namespace=None,
        parameters_json=None,
        num_parallel=0,
    ):
        if run_id and task_id:
            self.metadata.register_run_id(run_id)
            self.metadata.register_task_id(run_id, step_name, task_id, retry_count)
        else:
            raise MetaflowInternalError("run_id and task_id are required")

        # flight recorder: every record from here on carries this task's
        # full identity (run/step/task/attempt/rank/host) and persists to
        # the run's datastore at finalization — replacing any recorder
        # inherited across fork from the scheduler
        recorder = telemetry.init_recorder(
            self.flow_datastore, run_id, step_name, task_id,
            attempt=retry_count,
        )
        if recorder is not None:
            queued_ts = knobs.get_str("TPUFLOW_QUEUE_TS")
            if queued_ts:
                try:
                    recorder.gauge(
                        "task.queue_seconds",
                        round(max(0.0, time.time() - float(queued_ts)), 3),
                    )
                except ValueError:
                    pass
            if retry_count:
                recorder.event("task.retry_attempt",
                               data={"attempt": retry_count})

        flow = self.flow
        graph = flow._graph
        node = graph[step_name]
        step_func = getattr(flow, step_name)
        decorators = step_func.decorators

        output = self.flow_datastore.get_task_datastore(
            run_id, step_name, task_id, attempt=retry_count, mode="w"
        )
        output.init_task()

        # resolve inputs
        input_paths = input_paths or []
        input_stores = []
        for path in input_paths:
            parts = path.split("/")
            in_run, in_step, in_task = parts[-3], parts[-2], parts[-1]
            input_stores.append(
                self.flow_datastore.get_task_datastore(
                    in_run, in_step, in_task, mode="r"
                )
            )

        primary_input = input_stores[0] if input_stores else None
        is_join = node.type == "join"

        # initialize flow execution state
        flow._current_step = step_name
        flow._transition = None
        flow._cached_input = {}
        flow._success_internal = False

        if is_join:
            # joins start from a clean slate; user merges explicitly —
            # EXCEPT parameters, which the reference passes down through
            # the entire graph (reference task.py:191 passdown_partial):
            # every input carries the identical start-task values, so
            # inherit them from the first input
            if primary_input is not None:
                param_keys = [n for n, _ in flow._get_parameters()]
                param_keys.append("_parameter_names")
                for key in param_keys:
                    if key in primary_input._objects:
                        output._objects[key] = primary_input._objects[key]
                        output._info[key] = primary_input._info[key]
            flow._set_datastore(output)
        else:
            # inherit the (single) parent's artifacts: reads resolve through
            # the shared CAS manifests, zero data copied
            if primary_input is not None:
                output._objects.update(primary_input._objects)
                output._info.update(primary_input._info)
            flow._set_datastore(output)

        self._init_foreach(step_name, primary_input, split_index, node)

        if step_name == "start":
            self._init_parameters(parameters_json)
            flow._graph_meta = graph.output_steps()

        # `current` singleton
        current._set_env(
            flow=flow,
            run_id=run_id,
            step_name=step_name,
            task_id=task_id,
            retry_count=retry_count,
            origin_run_id=origin_run_id,
            namespace=namespace or "user:%s" % get_username(),
            username=get_username(),
            is_running=True,
            tags=(),
        )
        # event-triggered runs carry their consumed events in the
        # environment (set by the local trigger listener or the Argo
        # sensor's submit template) — expose them as `current.trigger`
        # (reference: metaflow/events.py Trigger via metaflow_current)
        trigger_json = knobs.get_str("TPUFLOW_TRIGGER_EVENTS")
        if trigger_json:
            try:
                from .events import Trigger

                events = json.loads(trigger_json)
                if isinstance(events, dict):
                    # the Argo sensor patches event bodies in one by one;
                    # the local listener sends a list
                    events = [events]
                # nulls = sensor dependencies whose body wasn't delivered
                # (or a manual submission of a subscribing flow)
                events = [e for e in events if e]
                if events:
                    current._update_env({"trigger": Trigger(events)})
            except Exception:
                pass  # malformed trigger info must not fail the task

        start_time = time.time()
        self.metadata.register_metadata(
            run_id,
            step_name,
            task_id,
            [
                MetaDatum("attempt", str(retry_count), "attempt", []),
                MetaDatum(
                    "origin-run-id", str(origin_run_id or ""), "origin-run-id", []
                ),
                MetaDatum("ds-type", self.flow_datastore.ds_type, "ds-type", []),
                MetaDatum("ds-root", self.flow_datastore.ds_root, "ds-root", []),
                MetaDatum(
                    "input-paths", json.dumps(input_paths), "input-paths", []
                ),
            ],
        )

        inputs_obj = None
        if is_join:
            if len(input_stores) > 1:
                # one batched fetch instead of N x M sequential gets; only
                # does work when a blob cache is attached (remote roots)
                self.flow_datastore.prefetch_task_artifacts(input_stores)
            inputs_obj = Inputs([InputDataStore(ds) for ds in input_stores])

        # every task converts SIGTERM (a spot reclaim notice, delivered
        # directly or via the monitor sidecar) into a retryable
        # TaskPreempted failure; user code can shield critical sections
        # via current.preemption
        from .plugins.gpu.preemption import PreemptionHandler

        preemption = PreemptionHandler().install()
        current._update_env({"preemption": preemption})

        from . import progress

        exception = None
        suppressed = False
        try:
            for deco in decorators:
                deco.task_pre_step(
                    step_name,
                    output,
                    self.metadata,
                    run_id,
                    task_id,
                    flow,
                    graph,
                    retry_count,
                    max_user_code_retries,
                    self.ubf_context,
                    inputs_obj,
                )

            wrapped = step_func
            for deco in decorators:
                wrapped = deco.task_decorate(
                    wrapped, flow, graph, retry_count, max_user_code_retries,
                    self.ubf_context,
                )

            # telemetry mirrors the reference's task wrap (task.py:793-807)
            with self.monitor.count("metaflow.task.start"):
                pass
            self.event_logger.log(
                {"event": "task_start", "pathspec": output.pathspec,
                 "attempt": retry_count}
            )
            telemetry.event("task.start",
                            data={"pathspec": output.pathspec})
            with telemetry.timer("task.user_code"):
                with self.monitor.measure("metaflow.task.duration"):
                    self._exec_step_function(wrapped, step_func, inputs_obj)

            for deco in decorators:
                deco.task_post_step(
                    step_name, flow, graph, retry_count, max_user_code_retries
                )
            flow._task_ok = True
            flow._success_internal = True
        except Exception as ex:
            exception = ex
            tb = traceback.format_exc()
            self.console_logger(tb)
            telemetry.event(
                "task.exception",
                data={"type": type(ex).__name__,
                      "preempted": isinstance(ex, TaskPreempted)})
            if isinstance(ex, TaskPreempted) and preemption.spot_notice:
                telemetry.event("task.preempted",
                                data={"spot_notice": True})
                # record the preemption as queryable task metadata (the
                # reference's spot sidecar writes the same kind of marker).
                # Only for a REAL spot notice (monitor marker): a routine
                # teardown SIGTERM (gang control killing workers after a
                # rank failure) must not masquerade as capacity reclaim.
                self.metadata.register_metadata(
                    run_id, step_name, task_id,
                    [MetaDatum("preempted", "true", "preemption",
                               ["attempt_id:%d" % retry_count])],
                )
            for deco in decorators:
                if deco.task_exception(
                    ex, step_name, flow, graph, retry_count, max_user_code_retries
                ):
                    suppressed = True
            flow._task_ok = suppressed
            flow._exception_str = "%s: %s" % (type(ex).__name__, ex)
        finally:
            preemption.uninstall()
            # terminal progress beat (only if this task ever beat): the
            # post-loop persist/teardown must not read as a stall
            progress.finish()
            if node.type != "end" and flow._transition is None and (
                exception is None or suppressed
            ):
                flow._task_ok = False
                exception = exception or TpuFlowException(
                    "Step *%s* did not call self.next() — every non-end step "
                    "must end with a transition." % step_name
                )
                suppressed = False

            duration = int((time.time() - start_time) * 1000)
            task_ok = bool(getattr(flow, "_task_ok", False))

            try:
                if task_ok:
                    # strip the big _parallel_ubf_iter marker before persist
                    flow.__dict__.pop("_cached_input", None)
                    output.persist(flow)

                for deco in decorators:
                    try:
                        deco.task_finished(
                            step_name, flow, graph, task_ok, retry_count,
                            max_user_code_retries,
                        )
                    except Exception as hook_ex:
                        # a failed task_finished hook must fail the attempt
                        # *attributably*: record the exception so the failure
                        # path below raises and the worker exits nonzero —
                        # otherwise the scheduler sees a "successful" task
                        # with no DONE marker and fails the run with a
                        # generic error
                        task_ok = False
                        self.console_logger(traceback.format_exc())
                        # a suppressed (@catch) step exception is not the
                        # cause of this failure — the hook error is
                        if exception is None or suppressed:
                            exception = hook_ex
                            suppressed = False

                self.metadata.register_metadata(
                    run_id,
                    step_name,
                    task_id,
                    [
                        MetaDatum(
                            "attempt_ok", json.dumps(task_ok),
                            "internal_attempt_status",
                            ["attempt_id:%d" % retry_count],
                        ),
                        MetaDatum("duration-ms", str(duration), "duration", []),
                    ],
                )
            finally:
                # the flight recorder's finalization flush: the task's
                # start→end span (with the final ok verdict) plus any
                # buffered tail persists even when persist/hooks raise —
                # and an in-flight finalization exception (persist or
                # metadata failure) downgrades the verdict, since the
                # attempt IS about to fail
                try:
                    finalize_exc = sys.exc_info()[1]
                    telemetry.emit(
                        "timer", "task.duration", ms=duration,
                        ok=task_ok and finalize_exc is None)
                    telemetry.close_recorder()
                except Exception:
                    pass  # observability must never fail the task

            if task_ok:
                if self.ubf_context == UBF_CONTROL:
                    self._finalize_control_task(output)
                output.done()
                current._set_env(is_running=False)
            else:
                current._set_env(is_running=False)
                if exception is not None:
                    raise TaskFailedException(
                        "Step %s (task-id %s) failed: %s"
                        % (step_name, task_id, exception)
                    ) from exception

    def _finalize_control_task(self, output):
        """Validate that all gang worker tasks completed (reference:
        task.py:_finalize_control_task:535).

        Externally-launched gangs (Indexed Job / gcloud: one process per
        rank, nothing for the control to wait() on) leave a window where
        rank 0 exits its last collective while workers are still
        persisting artifacts — poll for their done markers instead of
        failing on the race. The local fork path reaped its children
        already, so the first poll succeeds immediately there."""
        mapper_tasks = self.flow.__dict__.get("_control_mapper_tasks")
        if not mapper_tasks:
            raise MetaflowInternalError(
                "Control task did not record _control_mapper_tasks: the gang "
                "step must register its worker task pathspecs."
            )
        deadline = time.time() + knobs.get_float(
            "TPUFLOW_GANG_FINALIZE_TIMEOUT")
        for pathspec in mapper_tasks:
            parts = pathspec.split("/")
            run, step, task = parts[-3], parts[-2], parts[-1]
            if task == output.task_id:
                continue  # the control task itself: its DONE is written next
            while True:
                ds = self.flow_datastore.get_task_datastore(
                    run, step, task, mode="d"
                )
                if ds.is_done():
                    break
                if time.time() > deadline:
                    raise TaskFailedException(
                        "Gang worker task %s did not finish successfully."
                        % pathspec
                    )
                time.sleep(1)
