"""Decorator machinery: base classes + the 11-hook step lifecycle.

Reference behavior: metaflow/decorators.py (Decorator:115, StepDecorator:350,
FlowDecorator:245). Hooks, in call order over a task's life:

  step_init → package_init → step_task_retry_count → runtime_init →
  runtime_task_created → runtime_step_cli → task_pre_step → task_decorate →
  task_post_step / task_exception → task_finished

`runtime_step_cli` is the trampoline point: a compute decorator (e.g. @gpu)
rewrites the task's argv to launch on remote hardware.
"""

import json
import re

from .exception import (
    TpuFlowException,
    InvalidDecoratorAttribute,
)


class BadStepDecoratorException(TpuFlowException):
    headline = "Syntax error"

    def __init__(self, deco, func):
        msg = (
            "@{deco} was applied to '{func}', but '{func}' is not a step. "
            "Step decorators stack on top of @step: put @step directly above "
            "the method and @{deco} above that.".format(
                deco=deco, func=func.__name__
            )
        )
        super().__init__(msg=msg)


class DuplicateStepDecoratorException(TpuFlowException):
    headline = "Duplicate decorators"

    def __init__(self, deco, func):
        msg = (
            "Step '{step}' already has a decorator '@{deco}'. You can specify "
            "each decorator only once.".format(step=func.__name__, deco=deco)
        )
        super().__init__(msg=msg)


class DuplicateFlowDecoratorException(TpuFlowException):
    headline = "Duplicate decorators"

    def __init__(self, deco):
        msg = (
            "Flow already has a decorator '@{deco}'. You can specify each "
            "decorator only once.".format(deco=deco)
        )
        super().__init__(msg=msg)


class UnknownStepDecoratorException(TpuFlowException):
    headline = "Unknown step decorator"

    def __init__(self, deconame):
        from .plugins import STEP_DECORATORS

        decos = ", ".join(sorted(STEP_DECORATORS))
        msg = (
            "Unknown step decorator *{deconame}*. The following decorators "
            "are supported: *{decos}*".format(deconame=deconame, decos=decos)
        )
        super().__init__(msg=msg)


class Decorator(object):
    """Base for step- and flow-level decorators.

    Attributes are given either in code (`@retry(times=2)`) or on the command
    line as a spec (`--with retry:times=2`).
    """

    name = "NONAME"
    defaults = {}
    allow_multiple = False

    def __init__(self, attributes=None, statically_defined=False):
        self.attributes = dict(self.defaults)
        self.statically_defined = statically_defined
        if attributes:
            for k, v in attributes.items():
                if k in self.defaults or k.startswith("_"):
                    self.attributes[k] = v
                else:
                    raise InvalidDecoratorAttribute(self.name, k, self.defaults)

    @classmethod
    def parse_decorator_spec(cls, deco_spec):
        """Parse 'name:attr=val,attr2=val2' (reference: decorators.py:190)."""
        if not deco_spec:
            return cls()
        attrs = {}
        # tokenize on commas not inside brackets/quotes
        for field in re.split(r""",(?=[^\]\}]*(?:[\[\{]|$))""", deco_spec):
            if not field:
                continue
            name, _, val = field.partition("=")
            if not val:
                attrs[name.strip()] = True
                continue
            val = val.strip()
            try:
                attrs[name.strip()] = json.loads(val)
            except json.JSONDecodeError:
                attrs[name.strip()] = val
        return cls(attributes=attrs)

    def make_decorator_spec(self):
        attrs = {k: v for k, v in self.attributes.items() if v is not None}
        if not attrs:
            return self.name
        parts = []
        for k, v in attrs.items():
            if isinstance(v, (dict, list, tuple, bool)):
                parts.append("%s=%s" % (k, json.dumps(v)))
            else:
                parts.append("%s=%s" % (k, v))
        return "%s:%s" % (self.name, ",".join(parts))

    def __str__(self):
        attrs = " %s" % json.dumps(self.attributes) if self.attributes else ""
        fmt = "%s%s" % (self.name, attrs)
        return "decorator<%s>" % fmt


class StepDecorator(Decorator):
    """Lifecycle hooks; subclasses override what they need.

    See module docstring for hook ordering; signatures follow the reference
    (metaflow/decorators.py:350-561) with the same semantics.
    """

    def step_init(
        self, flow, graph, step_name, decorators, environment, flow_datastore, logger
    ):
        pass

    def package_init(self, flow, step_name, environment):
        pass

    def add_to_package(self):
        return []

    def step_task_retry_count(self):
        """Return (user_retries, error_retries)."""
        return 0, 0

    def runtime_init(self, flow, graph, package, run_id):
        pass

    def runtime_task_created(
        self, task_datastore, task_id, split_index, input_paths, is_cloned, ubf_context
    ):
        pass

    def runtime_step_cli(self, cli_args, retry_count, max_user_code_retries, ubf_context):
        pass

    def task_pre_step(
        self,
        step_name,
        task_datastore,
        metadata,
        run_id,
        task_id,
        flow,
        graph,
        retry_count,
        max_user_code_retries,
        ubf_context,
        inputs,
    ):
        pass

    def task_decorate(
        self, step_func, flow, graph, retry_count, max_user_code_retries, ubf_context
    ):
        return step_func

    def task_post_step(
        self, step_name, flow, graph, retry_count, max_user_code_retries
    ):
        pass

    def task_exception(
        self, exception, step_name, flow, graph, retry_count, max_user_code_retries
    ):
        """Return True to suppress the exception (e.g. @catch)."""
        return False

    def task_finished(
        self, step_name, flow, graph, is_task_ok, retry_count, max_user_code_retries
    ):
        pass


class FlowDecorator(Decorator):
    options = {}

    def flow_init(
        self, flow, graph, environment, flow_datastore, metadata, logger, echo, options
    ):
        pass

    def get_top_level_options(self):
        return []


def _base_step_decorator(decotype, *args, **kwargs):
    """Shared implementation behind every @deco applied above @step."""

    def wrap(f):
        if not hasattr(f, "is_step"):
            raise BadStepDecoratorException(decotype.name, f)
        if (
            not decotype.allow_multiple
            and any(d.name == decotype.name for d in f.decorators)
        ):
            raise DuplicateStepDecoratorException(decotype.name, f)
        f.decorators.append(decotype(attributes=kwargs, statically_defined=True))
        return f

    if args:
        # bare form: @deco
        if len(args) != 1 or not callable(args[0]) or kwargs:
            raise TpuFlowException(
                "Decorator @%s called with invalid arguments." % decotype.name
            )
        return wrap(args[0])
    # parameterized form: @deco(attr=val)
    return wrap


def _base_flow_decorator(decotype, *args, **kwargs):
    def wrap(cls):
        if not hasattr(cls, "_flow_decorators"):
            cls._flow_decorators = {}
        # copy-on-write so subclasses don't mutate parents
        if "_flow_decorators" not in cls.__dict__:
            cls._flow_decorators = dict(cls._flow_decorators)
        if decotype.name in cls._flow_decorators and not decotype.allow_multiple:
            raise DuplicateFlowDecoratorException(decotype.name)
        deco = decotype(attributes=kwargs, statically_defined=True)
        cls._flow_decorators.setdefault(decotype.name, []).append(deco)
        return cls

    if args:
        if len(args) != 1 or not isinstance(args[0], type) or kwargs:
            raise TpuFlowException(
                "Decorator @%s called with invalid arguments." % decotype.name
            )
        return wrap(args[0])
    return wrap


def make_step_decorator(decotype):
    """Create the user-facing callable for a StepDecorator subclass."""

    def deco(*args, **kwargs):
        return _base_step_decorator(decotype, *args, **kwargs)

    deco.__name__ = decotype.name
    deco.__doc__ = decotype.__doc__
    return deco


def make_flow_decorator(decotype):
    def deco(*args, **kwargs):
        return _base_flow_decorator(decotype, *args, **kwargs)

    deco.__name__ = decotype.name
    deco.__doc__ = decotype.__doc__
    return deco


def _attach_decorators(flow, decospecs):
    """Attach --with decorators to every step where not already present."""
    for step in flow:
        _attach_decorators_to_step(step, decospecs)


def _attach_decorators_to_step(step, decospecs):
    from .plugins import STEP_DECORATORS

    for spec in decospecs:
        deconame, _, params = spec.partition(":")
        if deconame not in STEP_DECORATORS:
            raise UnknownStepDecoratorException(deconame)
        decotype = STEP_DECORATORS[deconame]
        if decotype.name not in (d.name for d in step.decorators):
            step.decorators.append(decotype.parse_decorator_spec(params))


def _init_flow_decorators(
    flow, graph, environment, flow_datastore, metadata, logger, echo, deco_options
):
    for decos in flow._flow_decorators.values():
        for deco in decos:
            deco.flow_init(
                flow, graph, environment, flow_datastore, metadata, logger, echo,
                deco_options,
            )


def _init_step_decorators(flow, graph, environment, flow_datastore, logger):
    for step in flow:
        for deco in step.decorators:
            deco.step_init(
                flow,
                graph,
                step.__name__,
                step.decorators,
                environment,
                flow_datastore,
                logger,
            )
