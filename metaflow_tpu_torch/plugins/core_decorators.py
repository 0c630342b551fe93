"""Core step decorators: @retry, @catch, @timeout, @environment, @resources
(the JAX package's plugins/core_decorators.py).

Reference behavior: metaflow/plugins/{retry,catch,timeout}_decorator.py,
environment_decorator.py, resources_decorator.py — same semantics, same
defaults (retry times=3, minutes_between_retries=2; timeout via SIGALRM).
"""

import os
import signal

from ..decorators import StepDecorator
from ..exception import TpuFlowException


class RetryDecorator(StepDecorator):
    """Retry the task on failure.

    @retry(times=3, minutes_between_retries=2)
    """

    name = "retry"
    defaults = {"times": 3, "minutes_between_retries": 2}

    def step_init(self, flow, graph, step_name, decorators, environment,
                  flow_datastore, logger):
        self.attributes["times"] = int(self.attributes["times"])

    def step_task_retry_count(self):
        return int(self.attributes["times"]), 0


class CatchDecorator(StepDecorator):
    """Swallow a step failure: the exception is stored as an artifact and the
    flow continues.

    @catch(var='compute_failed', print_exception=True)
    """

    name = "catch"
    defaults = {"var": None, "print_exception": True}

    def step_init(self, flow, graph, step_name, decorators, environment,
                  flow_datastore, logger):
        if graph[step_name].type == "foreach":
            raise TpuFlowException(
                "@catch is not supported on a foreach split step."
            )

    def _print_exception(self, step_name, flow, exception):
        import traceback

        print(
            "@catch caught an exception in step %s:" % step_name, flush=True
        )
        traceback.print_exc()

    def task_exception(self, exception, step_name, flow, graph, retry_count,
                       max_user_code_retries):
        # only catch after user-code retries are exhausted
        if retry_count < max_user_code_retries:
            return False
        if self.attributes["print_exception"]:
            self._print_exception(step_name, flow, exception)
        var = self.attributes["var"]
        failure = ExceptionProxy(exception)
        if var:
            setattr(flow, var, failure)
        # ensure the transition still happens for linear steps: user code may
        # have died before self.next(); re-derive from the static graph
        if flow._transition is None:
            node = graph[step_name]
            if node.type in ("linear", "join", "start"):
                flow._transition = (node.out_funcs, None, None)
        return True


class ExceptionProxy(object):
    """Picklable stand-in for a caught exception (reference: catch_decorator
    failure artifact)."""

    def __init__(self, exception):
        self.is_none = exception is None
        self.exception = repr(exception)
        self.type = type(exception).__name__
        import traceback

        self.stacktrace = traceback.format_exc()

    def __bool__(self):
        return not self.is_none

    def __repr__(self):
        return "ExceptionProxy(%s)" % self.exception


class TimeoutException(TpuFlowException):
    headline = "@timeout"


class TimeoutDecorator(StepDecorator):
    """Fail the task if it runs longer than the given duration.

    @timeout(seconds=0, minutes=0, hours=0)
    """

    name = "timeout"
    defaults = {"seconds": 0, "minutes": 0, "hours": 0}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.secs = (
            int(self.attributes["hours"]) * 3600
            + int(self.attributes["minutes"]) * 60
            + int(self.attributes["seconds"])
        )

    def step_init(self, flow, graph, step_name, decorators, environment,
                  flow_datastore, logger):
        if self.secs <= 0:
            raise TpuFlowException(
                "@timeout on step *%s* needs a positive duration." % step_name
            )
        self.step_name = step_name

    def task_pre_step(self, step_name, task_datastore, metadata, run_id,
                      task_id, flow, graph, retry_count, max_user_code_retries,
                      ubf_context, inputs):
        if retry_count <= max_user_code_retries:
            self._old_handler = signal.signal(signal.SIGALRM, self._sigalrm)
            signal.alarm(self.secs)

    def task_post_step(self, step_name, flow, graph, retry_count,
                       max_user_code_retries):
        self._reset()

    def task_exception(self, exception, step_name, flow, graph, retry_count,
                       max_user_code_retries):
        self._reset()
        return False

    def _reset(self):
        try:
            signal.alarm(0)
            if getattr(self, "_old_handler", None):
                signal.signal(signal.SIGALRM, self._old_handler)
        except ValueError:
            pass

    def _sigalrm(self, signum, frame):
        raise TimeoutException(
            "@timeout: step *%s* exceeded its timeout of %d seconds"
            % (self.step_name, self.secs)
        )


class EnvironmentDecorator(StepDecorator):
    """Inject environment variables for the task.

    @environment(vars={'KEY': 'value'})
    """

    name = "environment"
    defaults = {"vars": {}}

    def task_pre_step(self, step_name, task_datastore, metadata, run_id,
                      task_id, flow, graph, retry_count, max_user_code_retries,
                      ubf_context, inputs):
        os.environ.update(
            {k: str(v) for k, v in (self.attributes["vars"] or {}).items()}
        )


class ResourcesDecorator(StepDecorator):
    """Declare resource needs; merged into the compute backend's request
    (reference: resources_decorator.py). `gpu` counts cards; `tpu` (a TPU
    topology) is kept so a flow written for the JAX package parses.

    @resources(cpu=1, memory=4096, gpu=None, disk=None)
    """

    name = "resources"
    defaults = {"cpu": 1, "memory": 4096, "disk": None, "tpu": None, "gpu": None}
