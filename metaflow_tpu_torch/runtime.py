"""Local run orchestrator: subprocess-per-task scheduler (the JAX
package's runtime.py).

Reference behavior: metaflow/runtime.py (NativeRuntime:352, execute:794,
Worker:2238, CLIArgs:2094): BFS over the DAG, a worker pool of OS processes,
foreach fan-out, join barriers, switch, gang (UBF) control tasks, retries and
clone-based resume. Poll loop uses the selectors module (epoll) to stream
worker logs — the procpoll equivalent (reference: metaflow/procpoll.py).

Join bookkeeping here is intentionally simpler than the reference's
index-translation scheme (runtime.py:1076-1143): every queued task carries an
in-memory branch-context stack of (split_task_pathspec, expected_arrivals)
frames; a join instance is keyed by its innermost split task's pathspec, which
is unique per recursion iteration by construction.

The runtime parent never touches CUDA: a task forked from it must not
inherit a CUDA context (the fork guard refuses to fork once one exists,
and a @gpu step is launched by exec). The JAX package's elastic gang
supervisor, hang watchdog and pre-run analysis are not in the port yet;
the port runs their TPUFLOW_ELASTIC=0, TPUFLOW_HANG_DETECT=0 and
TPUFLOW_ANALYZE=0 paths, and setting TPUFLOW_ELASTIC, TPUFLOW_HANG_DETECT
or TPUFLOW_STRICT_CHECK true raises.
"""

import json
import os
import selectors
import subprocess
import sys
import time
from collections import deque

from . import knobs, telemetry, tracing
from .datastore.task_datastore import MAX_ATTEMPTS
from .exception import TpuFlowException
from .metadata.metadata import MetaDatum
from .unbounded_foreach import UBF_CONTROL
from .util import (
    compress_list,
    preexec_die_with_parent,
    write_latest_run_id,
)

PROGRESS_LINE = "[%s/%s (pid %s)] %s"

# knob -> the subsystem it switches on, which the port has not yet
UNPORTED_KNOBS = {
    "TPUFLOW_ELASTIC": "elastic gang supervisor (ROADMAP.md, slice 5: "
                       "Robustness)",
    "TPUFLOW_HANG_DETECT": "gang hang watchdog (ROADMAP.md, slice 5: "
                           "Robustness)",
    "TPUFLOW_STRICT_CHECK": "pre-run analysis gate (ROADMAP.md, slice 5: "
                            "Tooling)",
}


def refuse_unported_knobs(env=None):
    """Raise NotImplementedError when a knob of a subsystem the port has
    not yet is explicitly set true; unset, the port runs the JAX
    package's path with that knob at 0."""
    for name, what in UNPORTED_KNOBS.items():
        if knobs.is_set(name, env=env) and knobs.get_bool(name, env=env):
            raise NotImplementedError(
                "%s is set, but the port has no %s yet: unset it or set "
                "it to 0" % (name, what))


class TaskFailed(TpuFlowException):
    headline = "Task failure"


class _Task(object):
    """A schedulable unit: one (step, task_id) with its launch context."""

    __slots__ = (
        "step",
        "task_id",
        "input_paths",
        "split_index",
        "ctx",
        "branch",
        "ubf_context",
        "num_parallel",
        "attempt",
        "user_retries",
        "error_retries",
        "is_cloned",
        "origin_pathspec",
        "queued_ts",
    )

    def __init__(self, step, task_id, input_paths, split_index=None, ctx=(),
                 branch=(), ubf_context=None, num_parallel=0):
        self.step = step
        self.task_id = str(task_id)
        self.input_paths = input_paths
        self.split_index = split_index
        self.ctx = tuple(ctx)  # tuple of (split_pathspec, expected, kind)
        # branch index per ctx frame: orders arrivals at the matching join
        self.branch = tuple(branch)
        self.ubf_context = ubf_context
        self.num_parallel = num_parallel
        self.attempt = 0
        self.user_retries = 0
        self.error_retries = 0
        self.is_cloned = False
        self.origin_pathspec = None
        self.queued_ts = None


class CLIArgs(object):
    """Mutable description of a task's subprocess command line; compute
    decorators rewrite it in runtime_step_cli (trampoline point)."""

    def __init__(self, entrypoint, top_level_options, command_options, env):
        self.entrypoint = list(entrypoint)
        self.top_level_options = dict(top_level_options)
        self.command = "step"
        self.command_args = []
        self.command_options = dict(command_options)
        self.env = dict(env)

    def get_args(self):
        args = list(self.entrypoint)
        for k, v in self.top_level_options.items():
            if v is None or v is False:
                continue
            if v is True:
                args.append("--%s" % k)
            else:
                args.extend(["--%s" % k, str(v)])
        args.append(self.command)
        args.extend(self.command_args)
        for k, v in self.command_options.items():
            if v is None or v is False:
                continue
            if v is True:
                args.append("--%s" % k)
            else:
                args.extend(["--%s" % k, str(v)])
        return args


class ForkProc(object):
    """Popen-compatible handle for a fork()ed task worker (the warm-pool
    fast path: the child inherits the scheduler's already-imported modules,
    skipping ~2s of interpreter+import startup per task)."""

    def __init__(self, pid, stdout, stderr):
        self.pid = pid
        self.stdout = stdout
        self.stderr = stderr
        self.returncode = None

    def poll(self):
        if self.returncode is None:
            pid, status = os.waitpid(self.pid, os.WNOHANG)
            if pid == self.pid:
                self.returncode = (
                    -(status & 0x7F) if (status & 0x7F)
                    else (status >> 8) & 0xFF
                )
        return self.returncode

    def wait(self, timeout=None):
        deadline = time.time() + (timeout or 3600)
        while self.poll() is None:
            if time.time() > deadline:
                raise TimeoutError("fork worker %d" % self.pid)
            time.sleep(0.02)
        return self.returncode

    def terminate(self):
        import signal

        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self):
        import signal

        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


class Worker(object):
    def __init__(self, task, proc, echo):
        self.task = task
        self.proc = proc
        self.echo = echo
        self.stdout_buf = b""
        self.stderr_buf = b""
        self._partial = {"stdout": b"", "stderr": b""}

    def read_stream(self, name, fileobj):
        """Read available bytes; returns the byte count (0 = nothing left)."""
        from . import mflog

        try:
            data = os.read(fileobj.fileno(), 65536)
        except (OSError, ValueError):
            return 0
        if not data:
            return 0
        buf = self._partial[name] + data
        *lines, self._partial[name] = buf.split(b"\n")
        for line in lines:
            # persist with the mflog structured header (timestamped merge
            # across sources on read); echo the plain line live
            tagged = mflog.decorate(mflog.TASK, line)
            if name == "stdout":
                self.stdout_buf += tagged
            else:
                self.stderr_buf += tagged
            self.echo(
                PROGRESS_LINE
                % (
                    self.task.step,
                    self.task.task_id,
                    self.proc.pid,
                    line.decode("utf-8", errors="replace"),
                )
            )
        return len(data)

    def flush_partials(self):
        """Tag + persist any unterminated trailing line of each stream."""
        from . import mflog

        for name in ("stdout", "stderr"):
            if self._partial[name]:
                tagged = mflog.decorate(mflog.TASK, self._partial[name])
                if name == "stdout":
                    self.stdout_buf += tagged
                else:
                    self.stderr_buf += tagged
                self._partial[name] = b""


class NativeRuntime(object):
    def __init__(
        self,
        flow,
        graph,
        flow_datastore,
        metadata,
        environment=None,
        run_id=None,
        params=None,
        namespace=None,
        max_workers=16,
        max_num_splits=100,
        origin_run_id=None,
        clone_run_id=None,
        resume_step=None,
        echo=None,
        entrypoint=None,
        decospecs=None,
        flow_file=None,
    ):
        self._flow = flow
        self._graph = graph
        self._flow_datastore = flow_datastore
        self._metadata = metadata
        self._environment = environment
        self._params = params or {}
        self._namespace = namespace
        self._max_workers = max(1, int(max_workers))
        self._max_num_splits = int(max_num_splits)
        self._origin_run_id = origin_run_id
        self._clone_run_id = clone_run_id
        self._resume_step = resume_step
        refuse_unported_knobs()
        self._echo = echo or (lambda line: print(line, flush=True))
        self._decospecs = decospecs or []
        self._flow_file = flow_file or sys.argv[0]
        self._entrypoint = entrypoint or [sys.executable, self._flow_file]

        self.run_id = run_id or metadata.new_run_id(
            sys_tags=metadata.sticky_sys_tags(environment, _user())
        )
        metadata.register_run_id(self.run_id)

        self._task_index = 0
        self._run_queue = deque()
        self._active = {}  # fd-keyed via selector; pid -> Worker
        self._join_arrivals = {}  # (join_step, split_pathspec) -> list of tasks
        self._finished_tasks = 0
        self._cloned_tasks = 0
        self._failed = False
        # scheduler-state snapshot for external observers (status CLI, crash
        # forensics): join arrivals + queue are otherwise in-memory only;
        # throttled + change-deduped so remote roots
        # aren't hammered and a storage hiccup can't stall the poll loop
        # on identical re-uploads
        self._runstate_last = 0.0
        self._runstate_prev = None
        self._runstate_thread = None
        self._runstate_gen = 0

        # scheduler-scoped flight recorder: queue/launch/retry events land
        # in the run's _telemetry/ prefix alongside the tasks' own records.
        # All tasks (and gang ranks) of the run share ONE trace id —
        # synthesized from the run id when no ambient TRACEPARENT exists
        tracing.ensure_traceparent(self.run_id)
        self._recorder = None
        if telemetry.enabled():
            self._recorder = telemetry.FlightRecorder(
                flow_datastore, self.run_id, "_runtime", "scheduler",
                attempt=0,
            )

        # resume support: index the origin run's finished tasks
        self._origin_index = {}
        self._cloned_pathspecs = set()
        if clone_run_id:
            self._build_origin_index()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def execute(self):
        start_time = time.time()
        for step_func in self._flow:
            for deco in step_func.decorators:
                deco.runtime_init(self._flow, self._graph, None, self.run_id)
        write_latest_run_id(self._flow.name, self.run_id)
        self._metadata.start_run_heartbeat(self._flow.name, self.run_id)
        self._echo(
            "Workflow starting (run-id %s), see it in the UI or with "
            "Run('%s/%s')" % (self.run_id, self._flow.name, self.run_id)
        )
        self._queue_task(_Task("start", self._new_task_id(), []))

        sel = selectors.DefaultSelector()
        last_beat = time.time()
        hooks_ran = False
        try:
            while self._run_queue or self._active:
                # launch as many queued tasks as the worker pool allows
                while self._run_queue and \
                        len(self._active) < self._max_workers:
                    task = self._run_queue.popleft()
                    if self._maybe_clone(task):
                        continue
                    self._launch_worker(task, sel)

                # external-observer surfaces stay live while tasks run
                if time.time() - last_beat > 10:
                    self._metadata.heartbeat()
                    last_beat = time.time()
                    if self._recorder is not None:
                        self._recorder.flush()
                self._persist_runstate()

                if not self._active:
                    continue

                # poll worker pipes
                for key, _mask in sel.select(timeout=0.2):
                    worker, stream_name = key.data
                    worker.read_stream(stream_name, key.fileobj)

                # reap finished workers
                for pid in list(self._active):
                    worker = self._active[pid]
                    returncode = worker.proc.poll()
                    if returncode is None:
                        continue
                    # drain remaining output
                    for name, stream in (
                        ("stdout", worker.proc.stdout),
                        ("stderr", worker.proc.stderr),
                    ):
                        while worker.read_stream(name, stream):
                            pass
                        try:
                            sel.unregister(stream)
                        except (KeyError, ValueError):
                            pass
                        stream.close()
                    del self._active[pid]
                    self._task_finished(worker, returncode)
        except BaseException:
            # crash path (scheduling error, Ctrl-C): on_error hooks still run
            self._run_exit_hooks(success=False)
            hooks_ran = True
            raise
        finally:
            # never orphan live task subprocesses on an abnormal exit
            for worker in self._active.values():
                if worker.proc.poll() is None:
                    worker.proc.terminate()
            for worker in self._active.values():
                try:
                    worker.proc.wait(timeout=10)
                except Exception:
                    worker.proc.kill()
            sel.close()
            self._metadata.heartbeat()
            self._persist_runstate(force=True)
            if self._recorder is not None:
                try:
                    self._recorder.event(
                        "run.finished",
                        data={"failed": self._failed,
                              "tasks_run": self._finished_tasks,
                              "tasks_cloned": self._cloned_tasks,
                              "wall_seconds": round(
                                  time.time() - start_time, 3)})
                    self._recorder.close()
                except Exception:
                    pass  # observability must never fail the run

        if not hooks_ran:
            self._run_exit_hooks(success=not self._failed)
        if self._failed:
            raise TaskFailed("Workflow failed; see task logs above.")
        # announce completion on the event bus so @trigger_on_finish
        # subscribers can fire (the Argo path publishes from its onExit
        # finalizer instead)
        from .events import publish_run_finished

        publish_run_finished(self._flow, self.run_id)
        self._echo(
            "Done! Flow finished in %.1fs (%d tasks run, %d cloned)."
            % (time.time() - start_time, self._finished_tasks, self._cloned_tasks)
        )

    def _run_exit_hooks(self, success):
        for decos in getattr(self._flow, "_flow_decorators", {}).values():
            for deco in decos:
                if hasattr(deco, "run_hooks"):
                    deco.run_hooks(
                        success, "%s/%s" % (self._flow.name, self.run_id),
                        self._echo,
                    )

    # ------------------------------------------------------------------
    # queueing and transitions
    # ------------------------------------------------------------------

    def _new_task_id(self):
        self._task_index += 1
        return str(self._task_index)

    def _queue_task(self, task):
        # task-id registration happens at LAUNCH (not queue) time: a queued
        # task may still be satisfied by a resume clone under a different
        # (origin) task id, and registering the provisional id first would
        # leave a ghost task in metadata/the datastore tree that client
        # listings then trip over
        # determine retry budget from decorators
        user_retries, error_retries = 0, 0
        step_func = getattr(self._flow, task.step)
        for deco in step_func.decorators:
            u, e = deco.step_task_retry_count()
            user_retries = max(user_retries, u)
            error_retries = max(error_retries, e)
        task.user_retries = user_retries
        task.error_retries = error_retries
        for deco in step_func.decorators:
            deco.runtime_task_created(
                None, task.task_id, task.split_index, task.input_paths,
                task.is_cloned, task.ubf_context,
            )
        task.queued_ts = time.time()
        self._run_queue.append(task)

    def _pathspec(self, task):
        return "/".join((self.run_id, task.step, task.task_id))

    def _persist_runstate(self, force=False, min_interval=2.0):
        """Atomically snapshot live scheduler state to
        <flow>/<run>/_runstate.json so an external observer can reconstruct
        a run mid-flight (and a crash leaves forensics behind)."""
        now = time.time()
        if not force and now - self._runstate_last < min_interval:
            return
        self._runstate_last = now
        snap = {
            "queued": [t.step for t in self._run_queue],
            "active": [
                self._pathspec(w.task) for w in self._active.values()
            ],
            "finished_tasks": self._finished_tasks,
            "cloned_tasks": self._cloned_tasks,
            "failed": self._failed,
            "join_arrivals": {
                "%s @ %s" % key: [self._pathspec(t) for t in arrivals]
                for key, arrivals in self._join_arrivals.items()
            },
        }
        if snap == self._runstate_prev and not force:
            return  # hour-long steps must not re-upload identical snapshots

        self._runstate_gen += 1
        gen = self._runstate_gen

        def save(payload=dict(snap, ts=now), gen=gen):
            if gen != self._runstate_gen:
                # superseded while queued/stalled: a slow upload of an
                # older snapshot must not clobber a newer one (the final
                # crash snapshot in particular)
                return
            try:
                self._flow_datastore.save_runstate(self.run_id, payload)
                # only a successful save suppresses the next upload — a
                # failed one retries as soon as the poll loop comes back
                self._runstate_prev = snap
            except Exception:
                pass  # observability must never fail the run

        if force:
            # crash/exit path: the process may be about to die. Join any
            # in-flight background upload first so a slower, older snapshot
            # can't land after (and clobber) this final one; if the join
            # times out, the generation check stops a stale thread that
            # hasn't entered save_runstate yet (one already inside a
            # stalled backend call can still land late — unavoidable
            # without backend-side versioning).
            if self._runstate_thread is not None:
                self._runstate_thread.join(timeout=10)
            save()
            return
        # a degraded storage backend must not stall the poll loop (pipes
        # fill, heartbeats stall) — upload off-thread, latest-wins
        if self._runstate_thread is not None and self._runstate_thread.is_alive():
            return  # still uploading an older snapshot; retry next poll
        import threading

        self._runstate_thread = threading.Thread(target=save, daemon=True)
        self._runstate_thread.start()

    def _task_finished(self, worker, returncode):
        task = worker.task
        worker.flush_partials()
        try:
            ds = self._flow_datastore.get_task_datastore(
                self.run_id, task.step, task.task_id, attempt=task.attempt,
                mode="w",
            )
            ds.save_logs(
                "runtime",
                {"stdout": worker.stdout_buf, "stderr": worker.stderr_buf},
            )
        except Exception:
            pass

        if returncode != 0:
            # the JAX package's TPUFLOW_ELASTIC=0 path: unclassified
            # retries within the user budget, immediate relaunch
            max_retries = task.user_retries + task.error_retries
            if task.attempt < min(max_retries, MAX_ATTEMPTS - 1):
                task.attempt += 1
                self._echo(
                    "Task %s failed (attempt %d); retrying."
                    % (self._pathspec(task), task.attempt - 1)
                )
                if self._recorder is not None:
                    self._recorder.event(
                        "sched.task_retry",
                        data={"pathspec": self._pathspec(task),
                              "failed_attempt": task.attempt - 1,
                              "next_attempt": task.attempt,
                              "returncode": returncode})
                task.queued_ts = time.time()
                self._run_queue.append(task)
                return
            self._echo("Task %s failed." % self._pathspec(task))
            if self._recorder is not None:
                self._recorder.event(
                    "sched.task_failed",
                    data={"pathspec": self._pathspec(task),
                          "attempt": task.attempt,
                          "returncode": returncode})
            self._failed = True
            # fail fast: drain the queue, let active workers finish
            self._run_queue.clear()
            return

        self._finished_tasks += 1
        if self._recorder is not None:
            self._recorder.event(
                "sched.task_finished",
                data={"pathspec": self._pathspec(task),
                      "attempt": task.attempt})
        self._schedule_successors(task)

    def _load_result(self, task):
        ds = self._flow_datastore.get_task_datastore(
            self.run_id, task.step, task.task_id, mode="r"
        )
        return ds

    def _schedule_successors(self, task):
        """Read the finished task's transition and queue what comes next."""
        node = self._graph[task.step]
        if node.type == "end":
            return
        ds = self._load_result(task)
        transition = ds.get("_transition")
        if transition is None:
            self._failed = True
            self._run_queue.clear()
            return
        funcs = transition[0]
        my_pathspec = self._pathspec(task)

        if node.type in ("foreach", "split-parallel"):
            child = funcs[0]
            num_splits = ds.get("_foreach_num_splits")
            unbounded = bool(ds.get("_unbounded_foreach"))
            if unbounded or node.type == "split-parallel":
                # gang: ONE control task owns the fan-out
                ctx = task.ctx + ((my_pathspec, 1, "parallel"),)
                control = _Task(
                    child,
                    self._new_task_id(),
                    [my_pathspec],
                    split_index=0,
                    ctx=ctx,
                    # mirror the ctx push so the pop at the gang join keeps
                    # any OUTER split's branch index intact
                    branch=task.branch + (0,),
                    ubf_context=UBF_CONTROL,
                    num_parallel=int(num_splits or 0),
                )
                self._queue_task(control)
                return
            if num_splits > self._max_num_splits:
                raise TaskFailed(
                    "Foreach in step *%s* yields %d splits which exceeds "
                    "--max-num-splits %d."
                    % (task.step, num_splits, self._max_num_splits)
                )
            ctx = task.ctx + ((my_pathspec, num_splits, "foreach"),)
            for i in range(num_splits):
                self._queue_task(
                    _Task(
                        child,
                        self._new_task_id(),
                        [my_pathspec],
                        split_index=i,
                        ctx=ctx,
                        branch=task.branch + (i,),
                    )
                )
            return

        if node.type == "split":
            ctx = task.ctx + ((my_pathspec, len(funcs), "split"),)
            for i, child in enumerate(funcs):
                self._queue_task(
                    _Task(child, self._new_task_id(), [my_pathspec], ctx=ctx,
                          branch=task.branch + (i,))
                )
            return

        # linear / switch / start / join: single (chosen) successor each
        for child in funcs:
            child_node = self._graph[child]
            if child_node.type == "join":
                self._arrive_at_join(child, task, ds)
            else:
                self._queue_task(
                    _Task(child, self._new_task_id(), [my_pathspec],
                          ctx=task.ctx, branch=task.branch)
                )

    def _arrive_at_join(self, join_step, task, ds):
        if not task.ctx:
            raise TaskFailed(
                "Task %s arrived at join %s with an empty split context"
                % (self._pathspec(task), join_step)
            )
        split_pathspec, expected, kind = task.ctx[-1]
        if kind == "parallel":
            # the control task arrives alone; its recorded gang membership
            # is the full input list
            mapper_tasks = ds.get("_control_mapper_tasks") or []
            self._queue_task(
                _Task(
                    join_step,
                    self._new_task_id(),
                    list(mapper_tasks),
                    ctx=task.ctx[:-1],
                    branch=task.branch[:-1] if task.branch else (),
                )
            )
            return
        key = (join_step, split_pathspec)
        arrivals = self._join_arrivals.setdefault(key, [])
        arrivals.append(task)
        if len(arrivals) == expected:
            # order join inputs by branch index (foreach split order /
            # static-split declaration order), not completion order
            arrivals.sort(key=lambda t: t.branch[-1] if t.branch else 0)
            input_paths = [self._pathspec(t) for t in arrivals]
            self._queue_task(
                _Task(
                    join_step,
                    self._new_task_id(),
                    input_paths,
                    ctx=task.ctx[:-1],
                    branch=task.branch[:-1] if task.branch else (),
                )
            )
            del self._join_arrivals[key]

    # ------------------------------------------------------------------
    # worker launch
    # ------------------------------------------------------------------

    def _launch_worker(self, task, sel):
        self._metadata.register_task_id(
            self.run_id, task.step, task.task_id, 0
        )
        if self._recorder is not None:
            queue_s = (time.time() - task.queued_ts) if task.queued_ts else 0
            self._recorder.event(
                "sched.task_launched",
                data={"pathspec": self._pathspec(task),
                      "attempt": task.attempt,
                      "queue_seconds": round(queue_s, 3)})
        if self._can_fork(task):
            proc = self._fork_worker(task)
        else:
            args = self._build_cli_args(task)
            env = dict(os.environ)
            env.update(args.env)
            if task.queued_ts:
                # tasks compute scheduler-queue time from this stamp
                env["TPUFLOW_QUEUE_TS"] = repr(task.queued_ts)
            # trace context rides into the task so all spans/records of
            # the run join one trace
            tracing.inject_tracing_vars(env)
            # own process group: terminating the task also reaps anything it
            # spawned (gang worker ranks, trampolined children) — a hung
            # rank must never outlive its control task
            proc = subprocess.Popen(
                args.get_args(),
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                bufsize=0,
                # session leader (group kills) + kernel reap on scheduler
                # death — a SIGKILLed scheduler must never orphan tasks
                preexec_fn=preexec_die_with_parent(os.getpid(),
                                                   setsid=True),
            )
            proc.terminate = _group_killer(proc, 15)  # SIGTERM
            proc.kill = _group_killer(proc, 9)        # SIGKILL
        worker = Worker(task, proc, self._echo)
        os.set_blocking(proc.stdout.fileno(), False)
        os.set_blocking(proc.stderr.fileno(), False)
        sel.register(proc.stdout, selectors.EVENT_READ, (worker, "stdout"))
        sel.register(proc.stderr, selectors.EVENT_READ, (worker, "stderr"))
        self._active[proc.pid] = worker

    def _can_fork(self, task):
        """Fork fast path is safe for plain steps: no gang contexts (the
        control task replays its argv for worker ranks) and no compute
        decorator that rewrites the CLI (trampolines need exec; @gpu
        steps are launched this way). Also skip once this process holds a
        CUDA context: it cannot cross fork (the JAX package refuses once a
        JAX backend is live, whose TPU driver fds must not be shared)."""
        if not knobs.get_bool("TPUFLOW_FORK_WORKERS"):
            return False
        if task.ubf_context is not None:
            return False
        from .decorators import StepDecorator
        from .plugins.parallel_decorator import ParallelDecorator

        step_func = getattr(self._flow, task.step)
        for deco in step_func.decorators:
            overrides_cli = (
                type(deco).runtime_step_cli is not StepDecorator.runtime_step_cli
            )
            if overrides_cli and not isinstance(deco, ParallelDecorator):
                # decorator rewrites the task CLI (trampoline): honor via exec
                return False
        torch = sys.modules.get("torch")  # never imported here for this check
        if torch is not None and torch.cuda.is_initialized():
            return False
        return True

    def _fork_worker(self, task):
        r_out, w_out = os.pipe()
        r_err, w_err = os.pipe()
        # build the preexec BEFORE forking — the fork child must not
        # import (an inherited held import lock would deadlock it)
        die_with_scheduler = preexec_die_with_parent(os.getpid())
        pid = os.fork()
        if pid == 0:
            # ---- child: become the task ----
            try:
                die_with_scheduler()
                os.close(r_out)
                os.close(r_err)
                os.dup2(w_out, 1)
                os.dup2(w_err, 2)
                os.close(w_out)
                os.close(w_err)
                rc = self._run_task_in_child(task)
            except BaseException:
                import traceback as tb

                tb.print_exc()
                rc = 1
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(rc)
        os.close(w_out)
        os.close(w_err)
        return ForkProc(
            pid, os.fdopen(r_out, "rb", buffering=0),
            os.fdopen(r_err, "rb", buffering=0),
        )

    def _run_task_in_child(self, task):
        """Child-side task execution: mirrors cli.step_cmd without the
        interpreter round-trip."""
        from .task import MetaflowTask, TaskFailedException

        if task.queued_ts:
            # the fork child inherits the scheduler env; stamp the queue
            # time the exec path passes via the subprocess env
            os.environ["TPUFLOW_QUEUE_TS"] = repr(task.queued_ts)
        self._metadata.start_task_heartbeat(
            self._flow.name, self.run_id, task.step, task.task_id
        )
        import threading

        beat_stop = threading.Event()

        def beats():
            while not beat_stop.wait(10):
                self._metadata.heartbeat()

        threading.Thread(target=beats, daemon=True).start()
        executor = MetaflowTask(
            self._flow,
            self._flow_datastore,
            self._metadata,
            console_logger=lambda line: print(line, flush=True),
            ubf_context=task.ubf_context,
        )
        try:
            executor.run_step(
                task.step,
                self.run_id,
                task.task_id,
                origin_run_id=self._origin_run_id,
                input_paths=task.input_paths,
                split_index=task.split_index,
                retry_count=task.attempt,
                max_user_code_retries=task.user_retries,
                namespace=self._namespace,
                parameters_json=json.dumps(self._params)
                if task.step == "start" and self._params else None,
            )
            return 0
        except TaskFailedException:
            return 1
        except Exception:
            import traceback as tb

            tb.print_exc()
            return 1

    def _build_cli_args(self, task):
        top_level = {
            "datastore": self._flow_datastore.ds_type,
            "datastore-root": self._flow_datastore.ds_root,
            "metadata": self._metadata.TYPE,
            "quiet": True,
        }
        command_options = {
            "run-id": self.run_id,
            "task-id": task.task_id,
            "input-paths": compress_list(task.input_paths)
            if task.input_paths
            else None,
            "split-index": task.split_index,
            "retry-count": task.attempt,
            "max-user-code-retries": task.user_retries,
            "namespace": self._namespace,
            "ubf-context": task.ubf_context,
        }
        if self._origin_run_id:
            command_options["origin-run-id"] = self._origin_run_id
        if task.step == "start" and self._params:
            command_options["params-json"] = json.dumps(self._params)

        args = CLIArgs(
            entrypoint=self._entrypoint,
            top_level_options=top_level,
            command_options=command_options,
            env={},
        )
        args.command_args = [task.step]
        step_func = getattr(self._flow, task.step)
        for deco in step_func.decorators:
            deco.runtime_step_cli(
                args, task.attempt, task.user_retries, task.ubf_context
            )
        # the repeated top-level option --with appends manually
        extra = []
        for spec in self._decospecs:
            extra.extend(["--with", spec])
        if extra:
            args.entrypoint = args.entrypoint + extra
        return args

    # ------------------------------------------------------------------
    # clone / resume
    # ------------------------------------------------------------------

    def _build_origin_index(self):
        """Index the origin run's DONE tasks by (step, foreach-index-path).

        A recursive switch re-executes the same steps at the same foreach
        path once per iteration, so each key holds an ordered LIST of
        origin tasks (creation order = iteration order, task ids are
        monotonic); _maybe_clone replays them with a cursor, which keeps
        the cloned transitions walking the loop exactly as the origin run
        did (the reference tracks the same thing via its recursive
        iteration bookkeeping, runtime.py:1076)."""
        max_id = 0
        entries = []
        for ds in self._flow_datastore.get_task_datastores(
            run_id=self._clone_run_id
        ):
            if not ds.is_done():
                continue
            stack = ds.get("_foreach_stack") or []
            index_path = tuple(int(frame[1]) for frame in stack)
            entries.append((ds.step_name, index_path, ds))
            tid = ds.task_id.split("-")[0]
            if tid.isdigit():
                max_id = max(max_id, int(tid))

        def _task_order(ds):
            tid = ds.task_id.split("-")[0]
            return (0, int(tid)) if tid.isdigit() else (1, ds.task_id)

        entries.sort(key=lambda e: _task_order(e[2]))
        for step_name, index_path, ds in entries:
            self._origin_index.setdefault((step_name, index_path),
                                          []).append(ds)
        self._origin_clone_cursor = {}
        self._task_index = max_id

    def _maybe_clone(self, task):
        """Clone the origin run's equivalent task instead of executing, when
        safe (origin succeeded AND all of this task's inputs were cloned)."""
        if not self._clone_run_id:
            return False
        if self._resume_step and task.step == self._resume_step:
            return False
        # all inputs must themselves be clones for the outputs to be valid
        for path in task.input_paths:
            if path not in self._cloned_pathspecs:
                return False
        index_path = self._index_path_for(task)
        candidates = self._origin_index.get((task.step, index_path))
        if not candidates:
            return False
        # recursion-aware: the Nth visit of (step, path) clones the Nth
        # origin iteration
        cursor = self._origin_clone_cursor.get((task.step, index_path), 0)
        if cursor >= len(candidates):
            return False
        self._origin_clone_cursor[(task.step, index_path)] = cursor + 1
        self._clone_task(task, candidates[cursor])
        return True

    def _index_path_for(self, task):
        """Foreach index path this task WILL have, derived from its launch
        context (mirrors task.py _init_foreach)."""
        path = []
        # reconstruct from input task's stack + split_index
        if task.input_paths:
            parts = task.input_paths[0].split("/")
            in_ds = self._flow_datastore.get_task_datastore(
                parts[-3], parts[-2], parts[-1], mode="r"
            )
            stack = in_ds.get("_foreach_stack") or []
            path = [int(f[1]) for f in stack]
            node = self._graph[task.step]
            if node.type == "join":
                path = path[:-1]
            elif task.split_index is not None:
                path = path + [int(task.split_index)]
        return tuple(path)

    def _clone_task(self, task, origin_ds):
        new_ds = self._flow_datastore.get_task_datastore(
            self.run_id, task.step, origin_ds.task_id, attempt=0, mode="w"
        )
        new_ds.init_task()
        new_ds.clone(origin_ds)
        # gang control tasks record their run id inside an artifact: rewrite
        # it, and clone the worker tasks too (the forked ranks are not
        # scheduler-queued, so _maybe_clone never sees them)
        if "_control_mapper_tasks" in origin_ds:
            origin_mapper = origin_ds["_control_mapper_tasks"]
            mapper = [
                "/".join([self.run_id] + p.split("/")[-2:])
                for p in origin_mapper
            ]
            new_ds.save_artifacts([("_control_mapper_tasks", mapper)])
            for origin_path in origin_mapper:
                parts = origin_path.split("/")
                w_step, w_task = parts[-2], parts[-1]
                if w_task == origin_ds.task_id:
                    continue  # the control task itself
                w_origin = self._flow_datastore.get_task_datastore(
                    self._clone_run_id, w_step, w_task, mode="r"
                )
                w_new = self._flow_datastore.get_task_datastore(
                    self.run_id, w_step, w_task, attempt=0, mode="w"
                )
                w_new.init_task()
                w_new.clone(w_origin)
                w_new.done()
                self._metadata.register_task_id(self.run_id, w_step, w_task, 0)
                self._cloned_pathspecs.add(
                    "/".join((self.run_id, w_step, w_task))
                )
        new_ds.done()
        task.task_id = origin_ds.task_id
        task.is_cloned = True
        task.origin_pathspec = origin_ds.pathspec
        self._metadata.register_task_id(self.run_id, task.step, task.task_id, 0)
        self._metadata.register_metadata(
            self.run_id,
            task.step,
            task.task_id,
            [
                MetaDatum(
                    "origin-task", origin_ds.pathspec, "origin-task", []
                ),
                MetaDatum("attempt_ok", "true", "internal_attempt_status",
                          ["attempt_id:0"]),
            ],
        )
        self._cloned_pathspecs.add(self._pathspec(task))
        self._cloned_tasks += 1
        self._echo(
            "Cloned %s from %s" % (self._pathspec(task), origin_ds.pathspec)
        )
        self._schedule_successors(task)


def _group_killer(proc, sig):
    def _kill():
        # mirror Popen.send_signal's guard: once reaped, the pid (and its
        # pgid) may be recycled by an unrelated process
        if proc.returncode is not None:
            return
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(proc.pid, sig)
            except ProcessLookupError:
                pass

    return _kill


def _user():
    from .util import get_username

    return get_username()
