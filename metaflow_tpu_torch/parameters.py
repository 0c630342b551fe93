"""Typed flow parameters exposed on the CLI.

Reference behavior: metaflow/parameters.py (Parameter:276, JSONTypeClass:89,
DeployTimeField:108). Parameters are class-level attributes of a FlowSpec;
at `run` time each becomes a `--name` CLI option; inside a task the resolved
value is readable as `self.<name>`.
"""

import json

from .exception import (
    TpuFlowException,
    ParameterFieldFailed,
    ParameterFieldTypeMismatch,
)

# context_proto is the prototype ParameterContext used for deploy-time fields
context_proto = None


class JSONTypeClass(object):
    """Marker type: the CLI string is json.loads'ed."""

    name = "JSON"

    def convert(self, value, param=None, ctx=None):
        if not isinstance(value, str):
            return value
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            raise ParameterFieldFailed(
                "Parameter value '%s' is not valid JSON" % value
            )

    def __str__(self):
        return self.name

    def __repr__(self):
        return self.name


JSONType = JSONTypeClass()


class DeployTimeField(object):
    """A parameter attribute given as a function, evaluated at deploy time
    (reference: parameters.py:108)."""

    def __init__(self, parameter_name, field, fun, return_type=None):
        self.parameter_name = parameter_name
        self.field = field
        self.fun = fun
        self.return_type = return_type

    def __call__(self, deploy_time=False, context=None):
        try:
            val = self.fun(context)
        except TypeError:
            val = self.fun()
        except Exception as ex:
            raise ParameterFieldFailed(
                "Deploy-time function for parameter *%s* field *%s* failed: %s"
                % (self.parameter_name, self.field, ex)
            )
        if self.return_type is not None and not isinstance(val, self.return_type):
            raise ParameterFieldTypeMismatch(
                "Deploy-time function for parameter *%s* field *%s* must "
                "return %s" % (self.parameter_name, self.field, self.return_type)
            )
        return val


class DelayedEvaluationParameter(object):
    """Returned when a parameter needs a late resolution (e.g. IncludeFile)."""

    def __init__(self, name, field, fun):
        self._name = name
        self._field = field
        self._fun = fun

    def __call__(self):
        try:
            return self._fun()
        except Exception as e:
            raise ParameterFieldFailed(
                "Parameter *%s* field *%s* could not be resolved: %s"
                % (self._name, self._field, e)
            )


class Parameter(object):
    IS_CONFIG_PARAMETER = False

    def __get__(self, obj, objtype=None):
        # non-data descriptor: an instance attribute (set by the task
        # executor) wins; otherwise resolve through the task's datastore so
        # downstream steps in fresh processes see the run's value
        if obj is None:
            return self
        ds = obj.__dict__.get("_datastore")
        if ds is not None and self.name in ds:
            value = ds[self.name]
            object.__setattr__(obj, self.name, value)
            return value
        return self

    def __init__(self, name, **kwargs):
        self.name = name
        self.kwargs = dict(kwargs)
        if not name.replace("_", "").isalnum():
            raise TpuFlowException(
                "Parameter name *%s* is invalid: use alphanumeric characters "
                "and underscores only." % name
            )

    @property
    def is_required(self):
        req = self.kwargs.get("required", False)
        return bool(req) and "default" not in self.kwargs

    @property
    def is_string_type(self):
        ptype = self.kwargs.get("type", str)
        return ptype is str and isinstance(self.kwargs.get("default", ""), str)

    def resolve_default(self, context=None):
        default = self.kwargs.get("default")
        if isinstance(default, DeployTimeField) or callable(default) and not isinstance(
            default, JSONTypeClass
        ):
            if callable(default) and not isinstance(default, DeployTimeField):
                default = DeployTimeField(self.name, "default", default)
            return default(context=context)
        return default

    def convert(self, value):
        """Convert a CLI string to the parameter's declared type."""
        ptype = self.kwargs.get("type", None)
        if value is None:
            return None
        if isinstance(ptype, JSONTypeClass):
            return ptype.convert(value)
        if ptype is None:
            # infer from default
            default = self.kwargs.get("default")
            if default is not None and not callable(default):
                ptype = type(default)
            else:
                ptype = str
        if ptype is bool:
            if isinstance(value, bool):
                return value
            return str(value).lower() in ("1", "true", "yes", "on")
        try:
            return ptype(value)
        except (TypeError, ValueError):
            raise ParameterFieldTypeMismatch(
                "Parameter *%s* expected type %s, got value %r"
                % (self.name, getattr(ptype, "__name__", ptype), value)
            )

    @property
    def help(self):
        return self.kwargs.get("help")

    def __repr__(self):
        return "Parameter(name=%r)" % self.name


def add_custom_parameters(flow_cls):
    """Yield (name, Parameter) pairs declared on the flow class, in MRO order."""
    seen = set()
    params = []
    for cls in flow_cls.__mro__:
        for name, attr in cls.__dict__.items():
            if isinstance(attr, Parameter) and name not in seen:
                seen.add(name)
                params.append((name, attr))
    return params


def set_parameter_context(flow_name, echo, datastore, configs):
    # hook point for deploy-time parameter evaluation contexts
    global context_proto
    context_proto = {
        "flow_name": flow_name,
        "user_name": None,
        "parameter_name": None,
    }
