"""FlowSpec: the user-facing flow definition DSL.

Reference behavior: metaflow/flowspec.py (FlowSpecMeta:166, FlowSpec:266,
next():909, merge_artifacts:738, foreach_stack:654). A FlowSpec subclass's
@step methods form a DAG parsed from the AST (graph.py); executing the module
(`python flow.py run`) drives the CLI.
"""

import inspect
from itertools import islice

from .exception import (
    TpuFlowException,
    InvalidNextException,
    MissingInMergeArtifactsException,
    UnhandledInMergeArtifactsException,
)
from .graph import FlowGraph
from .parameters import add_custom_parameters
from .unbounded_foreach import ParallelUBF, UnboundedForeachInput

# artifacts never persisted to the datastore
INTERNAL_ARTIFACTS_SET = {
    "_datastore",
    "_cached_input",
    "_graph",
    "_flow_decorators",
    "_steps",
    "_parameters",
    "_success_internal",
}

MAXIMUM_FOREACH_VALUE_CHARS = 30


def step(f):
    """Mark a method as a step of the flow."""
    f.is_step = True
    f.decorators = []
    f.wrappers = []
    f.name = f.__name__
    return f


class _FlowState(object):
    """Per-class (not per-instance) lazily built state."""

    def __init__(self):
        self.graph = None


class FlowSpecMeta(type):
    def __new__(mcs, name, bases, namespace):
        cls = super().__new__(mcs, name, bases, namespace)
        if name == "FlowSpec" and not bases:
            return cls
        cls._flow_state = _FlowState()
        if "_flow_decorators" not in cls.__dict__:
            cls._flow_decorators = dict(getattr(cls, "_flow_decorators", {}))
        return cls


class FlowSpec(object, metaclass=FlowSpecMeta):
    """Base class for all flows. Subclass, add @step methods, and end the
    module with `if __name__ == '__main__': MyFlow()`."""

    # attribute names that always resolve on the instance, never the datastore
    _EPHEMERAL = INTERNAL_ARTIFACTS_SET

    _flow_decorators = {}

    def __init__(self, use_cli=True):
        self.name = self.__class__.__name__
        self._datastore = None
        self._transition = None
        self._cached_input = {}
        self._foreach_stack = []

        self._steps = [getattr(self, var) for var in dir(self)
                       if not var.startswith("__")
                       and getattr(getattr(self, var, None), "is_step", False)]

        if use_cli:
            from . import cli

            cli.main(self)

    @classmethod
    def _init_graph(cls):
        if cls._flow_state.graph is None:
            cls._flow_state.graph = FlowGraph(cls)
        return cls._flow_state.graph

    @property
    def _graph(self):
        return self.__class__._init_graph()

    @property
    def _graph_info(self):
        g = self._graph
        return {
            "file": inspect.getsourcefile(self.__class__),
            "steps": g.output_steps(),
            "doc": g.doc,
        }

    @property
    def script_name(self):
        fname = inspect.getfile(self.__class__)
        if fname.endswith(".pyc"):
            fname = fname[:-1]
        import os

        return os.path.basename(fname)

    @classmethod
    def _get_parameters(cls):
        return add_custom_parameters(cls)

    def __iter__(self):
        """Iterate over the step methods."""
        return iter(self._steps)

    def __getattr__(self, name):
        # only called when normal lookup fails: fall back to the datastore
        if name in ("_datastore", "_EPHEMERAL"):
            raise AttributeError(name)
        datastore = self.__dict__.get("_datastore")
        if datastore is not None and name in datastore:
            x = datastore[name]
            object.__setattr__(self, name, x)
            return x
        raise AttributeError(
            "Flow %s has no attribute '%s'" % (self.__class__.__name__, name)
        )

    def _set_datastore(self, datastore):
        self._datastore = datastore

    def __contains__(self, var):
        if var in self.__dict__:
            return True
        ds = self.__dict__.get("_datastore")
        return ds is not None and var in ds

    @property
    def index(self):
        """The index of this task in its (innermost) foreach branch, or None."""
        if self._foreach_stack:
            return self._foreach_stack[-1][1]
        return None

    @property
    def input(self):
        """The element of the foreach iterator assigned to this task."""
        return self._find_input()

    def foreach_stack(self):
        """List of (index, num_splits, value_repr) for each nested foreach."""
        return [
            (frame[1], frame[2], self._find_input(stack_index=i))
            for i, frame in enumerate(self._foreach_stack)
        ]

    def _find_input(self, stack_index=None):
        if stack_index is None:
            stack_index = len(self._foreach_stack) - 1
        if stack_index < 0 or not self._foreach_stack:
            return None
        if stack_index in self._cached_input:
            return self._cached_input[stack_index]
        frame = self._foreach_stack[stack_index]
        var, index = frame[0], frame[1]
        try:
            it = getattr(self, var)
        except AttributeError:
            return None
        if isinstance(it, UnboundedForeachInput):
            value = it[index]
        elif hasattr(it, "__getitem__"):
            value = it[index]
        else:
            # one-shot iterator: skip to the index
            value = next(islice(iter(it), index, index + 1))
        self._cached_input[stack_index] = value
        return value

    def merge_artifacts(self, inputs, exclude=None, include=None):
        """Propagate artifacts from join inputs onto self.

        Reference semantics (flowspec.py merge_artifacts:738): artifacts with
        a single unambiguous value among all inputs propagate automatically;
        conflicting ones must be set manually before calling, or excluded.
        """
        node = self._graph[self._current_step]
        if node.type != "join":
            raise TpuFlowException(
                "merge_artifacts can only be called in a join (a step that "
                "takes an extra *inputs* argument)."
            )
        exclude = set(exclude or [])
        include = set(include or [])
        if include and exclude:
            raise TpuFlowException(
                "Only one of 'include' and 'exclude' may be given to "
                "merge_artifacts."
            )
        to_merge = {}
        unresolved = []
        for inp in inputs:
            for var, sha in inp._datastore.items():
                if var in exclude or var.startswith("_"):
                    continue
                if include and var not in include:
                    continue
                if var in self.__dict__:
                    continue  # user already resolved it
                existing = to_merge.get(var)
                if existing is None:
                    to_merge[var] = (inp, sha)
                elif existing[1] != sha:
                    unresolved.append(var)
        unresolved = sorted(set(unresolved))
        if unresolved:
            raise UnhandledInMergeArtifactsException(
                "Step *%s* cannot merge the following artifacts because they "
                "have conflicting values across inputs: %s. Set them "
                "explicitly before merge_artifacts, or pass them in "
                "'exclude'." % (self._current_step, ", ".join(unresolved)),
                unresolved,
            )
        missing = [v for v in include if v not in to_merge and v not in self.__dict__]
        if missing:
            raise MissingInMergeArtifactsException(
                "Artifacts %s listed in 'include' were not found in any "
                "input." % ", ".join(missing),
                missing,
            )
        for var, (inp, _sha) in to_merge.items():
            setattr(self, var, getattr(inp, var))

    # `_current_step` is set by the task executor before invoking the step
    _current_step = None

    @staticmethod
    def _foreach_value_repr(item):
        if isinstance(item, (str, int, float, bool)):
            return str(item)[:MAXIMUM_FOREACH_VALUE_CHARS]
        return repr(item)[:MAXIMUM_FOREACH_VALUE_CHARS]

    def next(self, *dsts, **kwargs):
        """Declare the next step(s). Forms:

        - `self.next(self.a)` — linear
        - `self.next(self.a, self.b)` — static split
        - `self.next(self.body, foreach='items')` — foreach fan-out
        - `self.next(self.train, num_parallel=N)` — gang (one process per rank)
        - `self.next({'x': self.a, 'y': self.b}, condition='var')` — switch
        """
        step = self._current_step
        foreach = kwargs.pop("foreach", None)
        num_parallel = kwargs.pop("num_parallel", None)
        condition = kwargs.pop("condition", None)
        if kwargs:
            raise InvalidNextException(
                "Step *%s* passes an unknown keyword argument '%s' to "
                "self.next()." % (step, next(iter(kwargs)))
            )
        if self._transition is not None:
            raise InvalidNextException(
                "Multiple self.next() calls detected in step *%s*. Call "
                "self.next() only once." % step
            )

        if condition is not None:
            if len(dsts) != 1 or not isinstance(dsts[0], dict) or not dsts[0]:
                raise InvalidNextException(
                    "Step *%s*: with 'condition', pass a single non-empty "
                    "dict mapping condition values to steps." % step
                )
            if foreach is not None or num_parallel is not None:
                raise InvalidNextException(
                    "Step *%s*: a switch cannot be combined with foreach or "
                    "num_parallel." % step
                )
            try:
                condition_value = getattr(self, condition)
            except AttributeError:
                raise InvalidNextException(
                    "Condition variable *self.%s* in step *%s* does not "
                    "exist." % (condition, step)
                )
            cases = dsts[0]
            if condition_value not in cases:
                raise RuntimeError(
                    "Switch condition '%s' has value %r which is not among "
                    "the cases: %s"
                    % (condition, condition_value, list(cases.keys()))
                )
            chosen = cases[condition_value]
            try:
                name = chosen.__func__.__name__
            except AttributeError:
                raise InvalidNextException(
                    "Step *%s*: switch case values must be flow methods."
                    % step
                )
            self._transition = ([name], None, None)
            return

        if len(dsts) == 1 and isinstance(dsts[0], dict):
            raise InvalidNextException(
                "Step *%s*: dictionary argument requires the 'condition' "
                "parameter." % step
            )

        funcs = []
        for i, dst in enumerate(dsts):
            try:
                name = dst.__func__.__name__
            except AttributeError:
                raise InvalidNextException(
                    "In step *%s* argument %d of self.next() is not a "
                    "method of the flow." % (step, i + 1)
                )
            if not hasattr(self, name):
                raise InvalidNextException(
                    "Step *%s* transitions to unknown step *%s*."
                    % (step, name)
                )
            funcs.append(name)

        if num_parallel is not None:
            if num_parallel < 1:
                raise InvalidNextException(
                    "Step *%s*: num_parallel must be at least 1." % step
                )
            if len(dsts) != 1:
                raise InvalidNextException(
                    "Step *%s*: exactly one destination with num_parallel."
                    % step
                )
            foreach = "_parallel_ubf_iter"
            self._parallel_ubf_iter = ParallelUBF(int(num_parallel))

        if foreach is not None:
            if not isinstance(foreach, str):
                raise InvalidNextException(
                    "Step *%s*: the 'foreach' argument must be a string "
                    "(the name of a flow attribute)." % step
                )
            if len(dsts) != 1:
                raise InvalidNextException(
                    "Step *%s*: specify exactly one target for 'foreach'."
                    % step
                )
            try:
                foreach_iter = getattr(self, foreach)
            except AttributeError:
                raise InvalidNextException(
                    "Foreach variable *self.%s* in step *%s* does not exist."
                    % (foreach, step)
                )
            if isinstance(foreach_iter, UnboundedForeachInput):
                self._unbounded_foreach = True
                self._foreach_num_splits = getattr(
                    foreach_iter, "num_parallel", None
                )
            else:
                try:
                    self._foreach_num_splits = len(foreach_iter)
                except TypeError:
                    try:
                        materialized = list(foreach_iter)
                    except TypeError:
                        raise InvalidNextException(
                            "Foreach variable *self.%s* in step *%s* is not "
                            "iterable." % (foreach, step)
                        )
                    setattr(self, foreach, materialized)
                    self._foreach_num_splits = len(materialized)
                self._unbounded_foreach = False
                if self._foreach_num_splits == 0:
                    raise InvalidNextException(
                        "Foreach iterator over *%s* in step *%s* is empty."
                        % (foreach, step)
                    )
            self._foreach_var = foreach

        if not funcs:
            raise InvalidNextException(
                "Step *%s* calls self.next() without any destinations." % step
            )
        self._transition = (funcs, foreach, None)

    def __str__(self):
        step_name = getattr(self, "_current_step", None)
        if step_name:
            index = ",".join(str(idx) for idx, _, _ in self.foreach_stack())
            if index:
                return "<flow %s step %s[%s]>" % (self.name, step_name, index)
            return "<flow %s step %s>" % (self.name, step_name)
        return "<flow %s>" % self.name
