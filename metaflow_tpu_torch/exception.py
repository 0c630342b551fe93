"""The port's exception family: a headline and a message, which a command
line renders without a traceback (the JAX package's exception module,
after the reference Metaflow's MetaflowException family)."""

import traceback


class TpuFlowException(Exception):
    headline = "Flow error"

    def __init__(self, msg="", lineno=None):
        self.message = msg
        self.line_no = lineno
        super().__init__()

    def __str__(self):
        prefix = "line %d: " % self.line_no if self.line_no else ""
        return "%s%s" % (prefix, self.message)


# Keep the reference-compatible alias so user code reads naturally.
MetaflowException = TpuFlowException


class ExternalCommandFailed(TpuFlowException):
    headline = "External command failed"


class InvalidDecoratorAttribute(TpuFlowException):
    headline = "Unknown decorator attribute"

    def __init__(self, deconame, attr, defaults):
        msg = (
            "Decorator '{deco}' does not support the attribute '{attr}'. "
            "These attributes are supported: {defaults}.".format(
                deco=deconame, attr=attr, defaults=", ".join(defaults)
            )
        )
        super().__init__(msg=msg)


class CommandException(TpuFlowException):
    headline = "Invalid command"


class ParameterFieldFailed(TpuFlowException):
    headline = "Parameter field failed"


class ParameterFieldTypeMismatch(TpuFlowException):
    headline = "Parameter type mismatch"


class MetaflowInvalidPathspec(TpuFlowException):
    headline = "Invalid pathspec"


class MetaflowTaggingError(TpuFlowException):
    headline = "Tag mutation failed"


class MetaflowNotFound(TpuFlowException):
    headline = "Object not found"


class MetaflowNamespaceMismatch(TpuFlowException):
    headline = "Object not in namespace"

    def __init__(self, namespace):
        msg = "Object not in namespace '%s'" % namespace
        super().__init__(msg=msg)


class MetaflowInternalError(TpuFlowException):
    headline = "Internal error"


class MetaflowUnknownUser(TpuFlowException):
    headline = "Unknown user"

    def __init__(self):
        msg = (
            "Could not determine your user name based on environment variables "
            "($USERNAME etc.)"
        )
        super().__init__(msg=msg)


class InvalidNextException(TpuFlowException):
    """Raised by FlowSpec.next() on a malformed transition; points at the
    user's line (reference behavior: metaflow/exception.py InvalidNextException)."""

    headline = "Invalid self.next() transition"

    def __init__(self, msg):
        tb = traceback.extract_stack()
        # Walk back past library frames to the user's next() call site.
        self.file, self.line_no = tb[0][:2]
        for frame in reversed(tb):
            if "metaflow_tpu_torch" not in frame[0]:
                self.file, self.line_no = frame[:2]
                break
        super().__init__(msg=msg, lineno=self.line_no)


class TpuFlowDataMissing(TpuFlowException):
    headline = "Data missing"


class UnhandledInMergeArtifactsException(TpuFlowException):
    headline = "Unhandled artifacts in merge"

    def __init__(self, msg, unhandled):
        super().__init__(msg=msg)
        self.artifact_names = list(unhandled)


class MissingInMergeArtifactsException(TpuFlowException):
    headline = "Missing artifacts in merge"

    def __init__(self, msg, missing):
        super().__init__(msg=msg)
        self.artifact_names = list(missing)


class TaskPreempted(TpuFlowException):
    """The host received a preemption notice (spot capacity reclaim); the
    attempt fails retryably so the next attempt can resume from the last
    checkpoint."""

    headline = "Task preempted"
