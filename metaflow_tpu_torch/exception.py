"""The port's base exception: a headline and a message, which a command
line renders without a traceback (the JAX package's TpuFlowException)."""


class TpuFlowException(Exception):
    headline = "Flow error"

    def __init__(self, msg="", lineno=None):
        self.message = msg
        self.line_no = lineno
        super().__init__()

    def __str__(self):
        prefix = "line %d: " % self.line_no if self.line_no else ""
        return "%s%s" % (prefix, self.message)
