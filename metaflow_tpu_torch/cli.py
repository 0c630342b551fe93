"""Click CLI: `python flow.py run|resume|step|spin|show|dump|logs|tag|status|
output-dot` (the JAX package's cli.py).

Reference behavior: metaflow/cli.py (start group:235-333) +
cli_components/{run_cmds,step_cmd,dump_cmd}.py. The `step` command is the
hidden per-task entrypoint the runtime launches as a subprocess; `run` drives
the NativeRuntime scheduler.

Not in the port yet, each waiting for its subsystem: `check` (and the
static analysis), `card`, `argo-workflows` (and the step options of
compiled Argo workflows), `metrics`, `gc`, `list-triggers`, Configs
(`--config`, `--config-value`) and extension commands.
"""

import json
import os
import sys
import threading
import traceback

import click

from . import knobs
from .datastore import STORAGE_BACKENDS, FlowDataStore
from .decorators import (
    _attach_decorators,
    _init_step_decorators,
    _init_flow_decorators,
)
from .exception import TpuFlowException
from .lint import lint
from .metadata import METADATA_PROVIDERS
from .plugins.gpu.gpu_parallel import GpuParallelDecorator
from .plugins.parallel_decorator import ParallelDecorator
from .runtime import NativeRuntime
from .task import MetaflowTask
from .util import (
    decompress_list,
    get_tpuflow_root,
    read_latest_run_id,
    resolve_identity,
)

# the step command records its argv here so gang control tasks can replay it
# for worker ranks (plugins/parallel_decorator.py)
STEP_ARGV_ENV = "TPUFLOW_STEP_ARGV"


def echo(line):
    print(line, flush=True)


def echo_quiet(line):
    pass


class CliState(object):
    def __init__(self, flow):
        self.flow = flow
        self.graph = None
        self.flow_datastore = None
        self.metadata = None
        self.echo = echo
        self.quiet = False
        self.decospecs = []
        self.raw_decospecs = []
        self.finalized = False


def _prepare(state, decospecs):
    """Lint, attach --with decorators, auto-attach the gang decorator."""
    flow = state.flow
    state.graph = flow._graph
    lint(state.graph)
    if decospecs:
        _attach_decorators(flow, decospecs)
        state.decospecs = list(decospecs)
    # gang steps get a torch.distributed process group automatically
    for node in state.graph:
        if node.parallel_step:
            step_func = getattr(flow, node.name)
            if not any(
                isinstance(d, ParallelDecorator) for d in step_func.decorators
            ):
                step_func.decorators.append(
                    GpuParallelDecorator(statically_defined=False)
                )
    _init_flow_decorators(flow, state.graph, None, state.flow_datastore,
                          state.metadata, state.echo, state.echo, {})
    _init_step_decorators(flow, state.graph, None, state.flow_datastore, state.echo)


def _finalize(state):
    """Lint and init decorators ONCE per process."""
    if state.finalized:
        return
    _prepare(state, state.raw_decospecs)
    state.finalized = True


def _param_options(flow):
    opts = []
    for name, param in flow._get_parameters():
        kwargs = {"default": None, "required": False}
        if param.help:
            kwargs["help"] = param.help
        opts.append(click.Option(["--" + name.replace("_", "-"), name], **kwargs))
    return opts


def _parse_task_pathspec(pathspec):
    parts = pathspec.split("/")
    if len(parts) == 4:
        parts = parts[1:]  # allow flow/run/step/task
    if len(parts) != 3:
        raise TpuFlowException(
            "Specify a task as RUN_ID/STEP/TASK_ID; got %r" % pathspec
        )
    return parts


def _collect_params(flow, kwargs):
    params = {}
    for name, _param in flow._get_parameters():
        val = kwargs.pop(name, None)
        if val is not None:
            params[name] = val
    return params, kwargs


def make_cli(flow, state):
    """Build the flow's click command group. main() invokes it; the
    programmatic API (runner/click_api.py) introspects it so Runner kwargs
    track the CLI surface automatically."""
    from . import metaflow_config as _cfg

    @click.group(name=flow.name, invoke_without_command=False)
    @click.option("--datastore", default=_cfg.default_datastore,
                  type=click.Choice(list(STORAGE_BACKENDS)),
                  help="Artifact storage backend.")
    @click.option("--datastore-root", default=None,
                  help="Root path for the datastore.")
    @click.option("--metadata", default=_cfg.default_metadata,
                  type=click.Choice(list(METADATA_PROVIDERS)),
                  help="Metadata provider.")
    @click.option("--quiet/--no-quiet", default=False)
    @click.option("--with", "decospecs", multiple=True,
                  help="Attach a decorator to all steps (name:attr=val,...)")
    @click.pass_context
    def start(ctx, datastore, datastore_root, metadata, quiet, decospecs):
        storage_impl = STORAGE_BACKENDS[datastore]
        state.flow_datastore = FlowDataStore(
            flow.name, storage_impl, ds_root=datastore_root
        )
        state.metadata = METADATA_PROVIDERS[metadata](flow=flow)
        state.quiet = quiet
        if quiet:
            state.echo = echo_quiet
        # lint + decorator init happen in _finalize, invoked by the
        # commands that execute the graph
        state.raw_decospecs = list(decospecs)
        ctx.obj = state

    @start.command(help="Run the workflow locally.")
    @click.option("--max-workers", default=16, show_default=True)
    @click.option("--max-num-splits", default=100, show_default=True)
    @click.option("--tag", "tags", multiple=True)
    @click.option("--run-id-file", default=None)
    @click.option("--namespace", "user_namespace", default=None)
    @click.pass_obj
    def run(state, max_workers, max_num_splits, tags, run_id_file,
            user_namespace, **kwargs):
        _finalize(state)
        params, _ = _collect_params(state.flow, kwargs)
        state.metadata.add_sticky_tags(tags=tags)
        runtime = NativeRuntime(
            state.flow,
            state.graph,
            state.flow_datastore,
            state.metadata,
            params=params,
            namespace=user_namespace or resolve_identity(),
            max_workers=max_workers,
            max_num_splits=max_num_splits,
            echo=echo,
            decospecs=state.decospecs,
        )
        if run_id_file:
            with open(run_id_file, "w") as f:
                f.write(str(runtime.run_id))
        runtime.execute()

    run.params.extend(_param_options(flow))

    @start.command(help="Resume a past run from where it failed.")
    @click.argument("step-to-rerun", required=False)
    @click.option("--origin-run-id", default=None,
                  help="Run to resume (default: latest run).")
    @click.option("--max-workers", default=16)
    @click.option("--max-num-splits", default=100)
    @click.option("--run-id-file", default=None)
    @click.pass_obj
    def resume(state, step_to_rerun, origin_run_id, max_workers,
               max_num_splits, run_id_file):
        origin = origin_run_id or read_latest_run_id(flow.name)
        if origin is None:
            raise TpuFlowException(
                "No previous run found for flow %s: nothing to resume."
                % flow.name
            )
        _finalize(state)
        if step_to_rerun and step_to_rerun not in state.graph:
            raise TpuFlowException(
                "Step *%s* does not exist in flow %s." % (step_to_rerun, flow.name)
            )
        # reuse the origin run's parameters
        params = {}
        try:
            origin_start = state.flow_datastore.get_task_datastores(
                run_id=origin, steps=["start"]
            )
            if origin_start:
                ds = origin_start[0]
                for name in ds.get("_parameter_names") or []:
                    params[name] = ds[name]
        except Exception:
            pass
        runtime = NativeRuntime(
            state.flow,
            state.graph,
            state.flow_datastore,
            state.metadata,
            params=params,
            namespace=resolve_identity(),
            max_workers=max_workers,
            max_num_splits=max_num_splits,
            origin_run_id=origin,
            clone_run_id=origin,
            resume_step=step_to_rerun,
            echo=echo,
            decospecs=state.decospecs,
        )
        if run_id_file:
            with open(run_id_file, "w") as f:
                f.write(str(runtime.run_id))
        runtime.execute()

    @start.command(hidden=True, help="Run a single task (internal).")
    @click.argument("step-name")
    @click.option("--run-id", required=True)
    @click.option("--task-id", required=True)
    @click.option("--input-paths", default=None)
    @click.option("--split-index", default=None)
    @click.option("--retry-count", default=0)
    @click.option("--max-user-code-retries", default=0)
    @click.option("--namespace", "user_namespace", default=None)
    @click.option("--ubf-context", default=None)
    @click.option("--origin-run-id", default=None)
    @click.option("--params-json", default=None)
    @click.pass_obj
    def step(state, step_name, run_id, task_id, input_paths, split_index,
             retry_count, max_user_code_retries, user_namespace, ubf_context,
             origin_run_id, params_json):
        _finalize(state)
        os.environ[STEP_ARGV_ENV] = json.dumps(sys.argv)
        if ubf_context not in (None, "", "none"):
            ubf = ubf_context
        else:
            ubf = None
        paths = decompress_list(input_paths) if input_paths else []

        # task heartbeat: mtime-based liveness, 10s cadence
        state.metadata.start_task_heartbeat(flow.name, run_id, step_name, task_id)
        beat_stop = threading.Event()

        def beats():
            while not beat_stop.wait(10):
                state.metadata.heartbeat()

        beat_thread = threading.Thread(target=beats, daemon=True)
        beat_thread.start()

        task = MetaflowTask(
            state.flow,
            state.flow_datastore,
            state.metadata,
            console_logger=echo,
            ubf_context=ubf,
        )
        try:
            task.run_step(
                step_name,
                run_id,
                task_id,
                origin_run_id=origin_run_id,
                input_paths=paths,
                split_index=int(split_index) if split_index not in (None, "") else None,
                retry_count=int(retry_count),
                max_user_code_retries=int(max_user_code_retries),
                namespace=user_namespace,
                parameters_json=params_json,
                num_parallel=0,
            )
        finally:
            beat_stop.set()

    @start.command(help="Re-run ONE task of a past run against its recorded "
                        "inputs (fast dev loop).")
    @click.argument("step-name")
    @click.option("--run-id", default=None, help="Origin run (default: latest)")
    @click.option("--task-id", default=None,
                  help="Origin task (default: first task of the step)")
    @click.pass_obj
    def spin(state, step_name, run_id, task_id):
        import time as _time

        _finalize(state)

        origin_run = run_id or read_latest_run_id(flow.name)
        if origin_run is None:
            raise TpuFlowException("No previous run to spin from.")
        if step_name not in state.graph:
            raise TpuFlowException("Step *%s* does not exist." % step_name)
        if state.graph[step_name].parallel_step:
            raise TpuFlowException("spin does not support gang steps.")
        if task_id is None:
            tasks = state.flow_datastore.list_tasks(origin_run, step_name)
            if not tasks:
                raise TpuFlowException(
                    "No task of step *%s* found in run %s."
                    % (step_name, origin_run)
                )
            task_id = sorted(tasks)[0]
        # recorded inputs from the origin task's metadata
        meta = state.metadata.get_task_metadata(
            flow.name, origin_run, step_name, task_id
        )
        input_paths = []
        for m in meta:
            if m.get("field_name") == "input-paths":
                input_paths = json.loads(m["value"])
        spin_run_id = "spin-%d" % int(_time.time() * 1000)
        state.metadata.register_run_id(spin_run_id, sys_tags=["spin"])
        echo("Spinning %s/%s/%s as run %s"
             % (origin_run, step_name, task_id, spin_run_id))
        origin_ds = state.flow_datastore.get_task_datastore(
            origin_run, step_name, task_id
        )
        split_index = None
        stack = origin_ds.get("_foreach_stack")
        if stack:
            split_index = stack[-1][1]
        # the start step has no input task: replay the origin's parameters
        params_json = None
        if step_name == "start":
            params = {
                name: origin_ds[name]
                for name in origin_ds.get("_parameter_names") or []
                if name in origin_ds
            }
            params_json = json.dumps(params)
        task = MetaflowTask(
            state.flow, state.flow_datastore, state.metadata,
            console_logger=echo,
        )
        task.run_step(
            step_name, spin_run_id, "1",
            origin_run_id=origin_run,
            input_paths=input_paths,
            split_index=split_index,
            parameters_json=params_json,
        )
        echo("Spin task done: %s/%s/1 — inspect with dump %s/%s/1"
             % (spin_run_id, step_name, spin_run_id, step_name))

    @start.group(help="Mutate run tags.")
    def tag():
        pass

    @tag.command(name="add")
    @click.option("--run-id", default=None)
    @click.argument("tags", nargs=-1, required=True)
    @click.pass_obj
    def tag_add(state, run_id, tags):
        run_id = run_id or read_latest_run_id(flow.name)
        info = state.metadata.mutate_run_tags(flow.name, run_id, add=tags)
        if info is None:
            raise TpuFlowException("Run %s not found" % run_id)
        echo("Tags of %s/%s: %s" % (flow.name, run_id,
                                    ", ".join(info["tags"])))

    @tag.command(name="remove")
    @click.option("--run-id", default=None)
    @click.argument("tags", nargs=-1, required=True)
    @click.pass_obj
    def tag_remove(state, run_id, tags):
        run_id = run_id or read_latest_run_id(flow.name)
        info = state.metadata.mutate_run_tags(flow.name, run_id, remove=tags)
        if info is None:
            raise TpuFlowException("Run %s not found" % run_id)
        echo("Tags of %s/%s: %s" % (flow.name, run_id,
                                    ", ".join(info["tags"])))

    @tag.command(name="list")
    @click.option("--run-id", default=None)
    @click.pass_obj
    def tag_list(state, run_id):
        run_id = run_id or read_latest_run_id(flow.name)
        info = state.metadata.get_run_info(flow.name, run_id)
        if info is None:
            raise TpuFlowException("Run %s not found" % run_id)
        for t in info.get("tags", []):
            echo(t)

    @start.command(help="Show the live status of a run (heartbeats, "
                        "attempts, durations).")
    @click.option("--run-id", default=None)
    @click.pass_obj
    def status(state, run_id):
        run_id = run_id or read_latest_run_id(flow.name)
        if run_id is None:
            raise TpuFlowException("No run found for %s." % flow.name)
        info = state.metadata.get_run_info(flow.name, run_id)
        if info is None:
            raise TpuFlowException("Run %s not found." % run_id)
        echo("Run %s/%s (user %s, tags: %s)"
             % (flow.name, run_id, info.get("user"),
                ", ".join(info.get("tags", [])) or "-"))
        # live scheduler snapshot, when one was persisted (runtime.py
        # _persist_runstate): shows in-flight state metadata can't
        try:
            rs = state.flow_datastore.load_runstate(run_id)
        except Exception:
            rs = None
        if rs:
            import time as _time

            echo(
                "  scheduler: %d queued, %d active, %d done"
                " (snapshot %.0fs ago)%s"
                % (
                    len(rs.get("queued", [])),
                    len(rs.get("active", [])),
                    rs.get("finished_tasks", 0),
                    max(0, _time.time() - rs.get("ts", 0)),
                    " FAILED" if rs.get("failed") else "",
                )
            )
        for step_name in state.flow_datastore.list_steps(run_id):
            for task_id in sorted(
                state.flow_datastore.list_tasks(run_id, step_name)
            ):
                ds = state.flow_datastore.get_task_datastore(
                    run_id, step_name, task_id, allow_not_done=True
                )
                meta = {
                    m["field_name"]: m["value"]
                    for m in state.metadata.get_task_metadata(
                        flow.name, run_id, step_name, task_id
                    )
                }
                age = state.metadata.task_heartbeat_age(
                    flow.name, run_id, step_name, task_id
                )
                # progress beat (tasks running an instrumented train
                # loop stamp _progress.json every step): distinguishes
                # HUNG? (alive by heartbeat, stalled by progress) from
                # DEAD? (no heartbeat at all)
                from .progress import read_progress

                beat = read_progress(
                    get_tpuflow_root(), flow.name, run_id, step_name,
                    task_id)
                prog = ""
                if beat and not beat.get("done"):
                    import time as _time

                    page = _time.time() - float(beat.get("ts") or 0.0)
                    prog = " step=%s prog=%.0fs" % (
                        beat.get("step_num"), max(0, page))
                if ds.is_done():
                    word = "done"
                elif age is not None and age < 30:
                    # a live heartbeat wins over a prior attempt's failure
                    # record (a retry may be running right now)
                    word = "running"
                    deadline = float(
                        (beat or {}).get("deadline_s") or 0.0)
                    if (beat and not beat.get("done") and deadline > 0
                            and page > deadline):
                        word = ("HUNG? (no progress %.0fs, deadline %.0fs)"
                                % (page, deadline))
                elif meta.get("attempt_ok") == "false":
                    word = "FAILED"
                elif age is not None:
                    word = "DEAD? (no heartbeat %.0fs)" % age
                else:
                    word = "pending"
                duration = meta.get("duration-ms")
                extra = " %sms" % duration if duration else ""
                extra += prog
                echo("  %-20s %-8s attempt=%s%s"
                     % ("%s/%s" % (step_name, task_id), word,
                        ds.attempt if ds.has_attempt() else "-", extra))

    @start.command(help="Show the structure of the flow.")
    @click.pass_obj
    def show(state):
        _finalize(state)
        echo("\n%s\n" % (state.graph.doc or flow.name))
        for name in state.graph.sorted_nodes():
            node = state.graph[name]
            echo("Step *%s* (%s)" % (name, node.type))
            if node.doc:
                echo("    %s" % node.doc)
            if node.type == "end":
                echo("    => done")
            else:
                extra = ""
                if node.type == "foreach":
                    extra = " (foreach over '%s')" % node.foreach_param
                elif node.type == "split-parallel":
                    extra = " (gang)"
                elif node.type == "split-switch":
                    extra = " (switch on '%s')" % node.condition
                echo("    => %s%s" % (", ".join(node.out_funcs), extra))

    @start.command(name="output-dot", help="Print the DAG in DOT format.")
    @click.pass_obj
    def output_dot(state):
        _finalize(state)
        print(state.graph.output_dot())

    @start.command(help="Dump artifacts of a task: dump RUN/STEP/TASK")
    @click.argument("pathspec")
    @click.option("--private/--no-private", default=False,
                  help="Include internal (underscore) artifacts.")
    @click.option("--max-value-size", default=1000)
    @click.pass_obj
    def dump(state, pathspec, private, max_value_size):
        run_id, step_name, task_id = _parse_task_pathspec(pathspec)
        ds = state.flow_datastore.get_task_datastore(run_id, step_name, task_id)
        for name, value in sorted(ds.to_dict(show_private=private).items()):
            rep = repr(value)
            if len(rep) > max_value_size:
                rep = rep[:max_value_size] + "..."
            print("%s = %s" % (name, rep))

    @start.command(help="Show logs of a task: logs RUN/STEP/TASK. "
                        "--scrub PERMANENTLY replaces the stored stream "
                        "with a scrub marker (leaked secrets, PII).")
    @click.argument("pathspec")
    @click.option("--stderr/--stdout", default=False)
    @click.option("--scrub", is_flag=True,
                  help="Overwrite the selected stream's persisted content "
                       "instead of showing it.")
    @click.pass_obj
    def logs(state, pathspec, stderr, scrub):
        run_id, step_name, task_id = _parse_task_pathspec(pathspec)
        ds = state.flow_datastore.get_task_datastore(
            run_id, step_name, task_id, allow_not_done=True
        )
        name = "stderr" if stderr else "stdout"
        from . import mflog

        if scrub:
            # EVERY attempt: failed attempts persist logs too, and a
            # leaked secret usually predates the successful retry
            from .datastore import MAX_ATTEMPTS

            marker = mflog.decorate(b"runtime", b"[log content scrubbed]")
            scrubbed = []
            for attempt in range(MAX_ATTEMPTS):
                att_ds = state.flow_datastore.get_task_datastore(
                    run_id, step_name, task_id, attempt=attempt,
                    allow_not_done=True,
                )
                if att_ds.load_log_legacy("runtime", name):
                    att_ds.save_logs("runtime", {name: marker})
                    scrubbed.append(attempt)
            echo("scrubbed %s of %s/%s/%s (attempts: %s)"
                 % (name, run_id, step_name, task_id,
                    ", ".join(map(str, scrubbed)) or "none"))
            return
        data = ds.load_log_legacy("runtime", name)
        sys.stdout.write(
            mflog.format_merged([data]).decode("utf-8", errors="replace")
        )

    return start


def main(flow, args=None):
    state = CliState(flow)
    start = make_cli(flow, state)

    try:
        start(args=args, standalone_mode=False, obj=state)
    except click.exceptions.ClickException as ex:
        ex.show()
        sys.exit(ex.exit_code)
    except TpuFlowException as ex:
        sys.stderr.write("%s: %s\n" % (ex.headline, str(ex)))
        if knobs.get_bool("TPUFLOW_DEBUG"):
            traceback.print_exc()
        sys.exit(1)
    except click.exceptions.Abort:
        sys.exit(1)
