"""Static graph checks run before every execution.

Reference behavior: metaflow/lint.py (21 checks, lint.py:50-530). Checks are
registered on a FlowLinter and run in order; each raises LintWarn with the
user's source line when violated.

Reference checks deliberately absent here:
- check_nested_foreach: nested foreaches are a SUPPORTED feature of this
  framework (tests/flows/nested_foreach_flow.py), not an error.
- check_annotation_name_conflict: @step(start=True) aliases don't exist
  here; start/end are identified by name only.
The parallel-placement family (check_parallel_step_after_next,
check_parallel_foreach_calls_parallel_step,
check_join_followed_by_parallel_step) is implemented at the bottom of
this file; the inferred-decorator direction is structurally impossible
here (the CLI auto-attaches the gang decorator from the num_parallel
transition) but the contracts are asserted anyway.
"""

from .exception import TpuFlowException


class LintWarn(TpuFlowException):
    headline = "Flow graph failed a lint check"

    def __init__(self, msg, lineno=None, source_file=None):
        if source_file and lineno:
            msg = "%s:%d: %s" % (source_file, lineno, msg)
        super().__init__(msg=msg, lineno=None)
        # structured location (the message embeds it for humans): consumed
        # by `check --json` and editor integrations
        self.lineno = lineno
        self.source_file = source_file


class FlowLinter(object):
    def __init__(self):
        self._checks = []

    def check(self, f):
        self._checks.append(f)
        f.attrs = []
        return f

    def ensure_static_graph(self, f):
        f.attrs.append("check_static_transitions")
        return f

    def run_checks(self, graph, **kwargs):
        for check in self._checks:
            check(graph)


linter = FlowLinter()


def _err(msg, node=None):
    if node is not None:
        raise LintWarn(msg, node.func_lineno, node.source_file)
    raise LintWarn(msg)


@linter.check
def check_reserved_words(graph):
    RESERVED = {"name", "next", "input", "index", "cmd"}
    for node in graph:
        if node.name in RESERVED:
            _err("Step name *%s* is a reserved word." % node.name, node)


@linter.check
def check_basic_steps(graph):
    for prefix in ("start", "end"):
        if prefix not in graph:
            raise LintWarn(
                "Add %s step in your flow: a flow must have a step named "
                "*%s* decorated with @step." % (prefix, prefix)
            )


@linter.check
def check_start_end_degree(graph):
    """start takes no incoming transitions; end emits none (reference:
    lint.py check_start_end_degree). Recursion via switch may target any
    step EXCEPT start — re-running start would re-resolve parameters."""
    if "start" in graph:
        incoming = [n.name for n in graph if "start" in n.out_funcs]
        if incoming:
            _err(
                "The *start* step has incoming transitions from %s. A start "
                "step must have no incoming transitions."
                % ", ".join(sorted(incoming)),
                graph["start"],
            )


@linter.check
def check_that_end_is_end(graph):
    node = graph["end"]
    if node.has_tail_next or node.invalid_tail_next:
        _err("The *end* step must not have a self.next() transition.", node)
    if node.num_args > 2:
        _err("The *end* step takes no extra arguments.", node)


@linter.check
def check_step_names(graph):
    for node in graph:
        if node.name.startswith("_") or not node.name.replace("_", "").isalnum():
            _err(
                "Step name *%s* is invalid: use alphanumeric characters and "
                "underscores only, and don't start with an underscore." % node.name,
                node,
            )


@linter.check
def check_num_args(graph):
    for node in graph:
        if node.num_args > 2:
            _err(
                "Step *%s* takes too many arguments: a step takes either "
                "(self) or (self, inputs) for a join." % node.name,
                node,
            )
        if node.num_args == 2 and node.type != "join":
            _err(
                "Step *%s* is defined with two arguments (self, inputs) but "
                "it is not preceded by a split: only join steps take the "
                "extra *inputs* argument." % node.name,
                node,
            )
        if node.num_args < 2 and node.type == "join":
            _err(
                "Step *%s* joins results of multiple parent steps so it must "
                "be defined as def %s(self, inputs)." % (node.name, node.name),
                node,
            )


@linter.check
def check_static_transitions(graph):
    for node in graph:
        if node.type != "end" and not node.has_tail_next:
            _err(
                "Step *%s* is missing a self.next() transition as its last "
                "statement." % node.name,
                node,
            )


@linter.check
def check_valid_transitions(graph):
    for node in graph:
        if node.type != "end" and node.has_tail_next and node.invalid_tail_next:
            _err(
                "Step *%s* has an invalid self.next() transition. Valid forms: "
                "self.next(self.one_step), self.next(self.a, self.b), "
                "self.next(self.body, foreach='attr'), "
                "self.next(self.gang, num_parallel=N), "
                "self.next({'case': self.a, ...}, condition='attr')." % node.name,
                node,
            )


@linter.check
def check_unknown_transitions(graph):
    for node in graph:
        unknown = [n for n in node.out_funcs if n not in graph]
        if unknown:
            _err(
                "Step *%s* transitions to unknown step(s): %s. Make sure all "
                "steps referenced in self.next() are decorated with @step."
                % (node.name, ", ".join(unknown)),
                node,
            )


@linter.check
def check_for_orphans(graph):
    seen = {"start"}
    frontier = ["start"] if "start" in graph else []
    while frontier:
        new = []
        for name in frontier:
            for out in graph[name].out_funcs:
                if out in graph and out not in seen:
                    seen.add(out)
                    new.append(out)
        frontier = new
    orphans = [n.name for n in graph if n.name not in seen]
    if orphans:
        raise LintWarn(
            "Step(s) %s are not reachable from the *start* step. Add "
            "transitions to them or remove them." % ", ".join(orphans)
        )


@linter.check
def check_for_acyclicity(graph):
    # Cycles are only allowed through a split-switch (recursive switch).
    # Iterative DFS with an explicit path stack: deep or generated graphs
    # (recursive-switch flows) must not blow Python's recursion limit
    # inside the linter itself.
    if "start" not in graph:
        return
    path = ["start"]
    on_path = {"start"}
    # stack of iterators over each path node's out-edges
    stack = [iter(graph["start"].out_funcs)]
    while stack:
        out = next(stack[-1], None)
        if out is None:
            stack.pop()
            on_path.discard(path.pop())
            continue
        if out not in graph:
            continue
        if out in on_path:
            # a back-edge is legal iff some node in the cycle is a switch
            node = graph[path[-1]]
            cycle = path[path.index(out):] + [out]
            if not any(graph[c].type == "split-switch" for c in cycle[:-1]):
                _err(
                    "There is a loop in your flow: %s. A flow must be a "
                    "directed acyclic graph (recursion is only allowed "
                    "via a switch transition)." % "->".join(cycle),
                    node,
                )
        else:
            path.append(out)
            on_path.add(out)
            stack.append(iter(graph[out].out_funcs))


@linter.check
def check_split_join_balance(graph):
    """Every join must line up with its nearest split; the end step must be
    reached with an empty split stack. (Reference: lint.py
    check_split_join_balance:294 — the subtlest invariant in the graph.)"""

    # iterative DFS (explicit worklist): generated or deeply-recursive
    # graphs must not die with RecursionError inside the linter. Same
    # semantics as the recursive original: first visit of a node wins.
    if "start" in graph:
        seen = set()
        worklist = [("start", ())]
        while worklist:
            name, split_stack = worklist.pop()
            if name in seen:
                continue
            seen.add(name)
            node = graph[name]
            # split-switch executes exactly ONE branch, so it needs no
            # join: treat it as linear for balance purposes
            if node.type == "split":
                split_stack = split_stack + ("split:%s" % node.name,)
            elif node.type == "foreach":
                split_stack = split_stack + ("foreach:%s" % node.name,)
            elif node.type == "split-parallel":
                split_stack = split_stack + ("parallel:%s" % node.name,)
            elif node.type == "join":
                if not split_stack:
                    _err(
                        "Step *%s* is a join (it takes an extra *inputs* "
                        "argument) but there is no split or foreach to "
                        "join." % node.name,
                        node,
                    )
                split_stack = split_stack[:-1]
            elif node.type == "end":
                if split_stack:
                    kind, split_name = split_stack[-1].split(":", 1)
                    _err(
                        "Step *end* reached before the %s started at step "
                        "*%s* was joined. Add a join step (def step(self, "
                        "inputs)) before *end*." % (kind, split_name),
                        node,
                    )
            for out in node.out_funcs:
                if out in graph:
                    worklist.append((out, split_stack))

    # a join must join the steps of exactly one split level: all of its
    # in_funcs must share the same innermost split parent
    for node in graph:
        if node.type != "join":
            continue
        parents = set()
        for in_func in node.in_funcs:
            if in_func in graph:
                p = graph[in_func].split_parents
                parents.add(p[-1] if p else None)
        if len(parents) > 1:
            _err(
                "Step *%s* joins steps from different splits (%s). A join "
                "can only join steps of the same split."
                % (node.name, ", ".join(sorted(node.in_funcs))),
                node,
            )


@linter.check
def check_parallel_rules(graph):
    for node in graph:
        if node.type == "split-parallel":
            if len(node.out_funcs) != 1:
                _err(
                    "Step *%s* uses num_parallel so it must transition to "
                    "exactly one (gang) step." % node.name,
                    node,
                )
        if node.parallel_step:
            # followed-by-join is asserted by
            # check_join_followed_by_parallel_step
            if node.type == "join":
                _err(
                    "Step *%s* cannot be both a join and a gang (@parallel) "
                    "step." % node.name,
                    node,
                )


@linter.check
def check_switch_rules(graph):
    for node in graph:
        if node.type == "split-switch":
            if not node.switch_cases:
                _err(
                    "Step *%s* has a switch transition with no cases."
                    % node.name,
                    node,
                )
            if not node.condition:
                _err(
                    "Step *%s* has a switch transition without a condition."
                    % node.name,
                    node,
                )


@linter.check
def check_ambiguous_joins(graph):
    """A switch branch must not lead straight into a join (reference:
    lint.py check_ambiguous_joins:505): the join's input arity would depend
    on the condition. An unconditional step must sit on that path."""
    for node in graph:
        if node.type != "join":
            continue
        switch_parents = [
            p for p in node.in_funcs
            if p in graph and graph[p].type == "split-switch"
        ]
        if switch_parents:
            _err(
                "A conditional (switch) path cannot lead directly to the "
                "join step *%s* (from %s). Add an intermediate step on that "
                "branch before joining."
                % (node.name, ", ".join(sorted(switch_parents))),
                node,
            )


@linter.check
def check_empty_foreaches(graph):
    for node in graph:
        if node.type == "foreach" and not node.foreach_param:
            _err(
                "Step *%s* has a foreach transition without an iterator "
                "attribute name." % node.name,
                node,
            )


@linter.check
def check_parallel_step_after_next(graph):
    """Reference parity (lint.py:446-455): every child of a
    num_parallel transition must be a gang step. In this framework the
    gang decorator is auto-attached from the transition, so a violation
    indicates graph-inference breakage rather than user error — but the
    contract is still asserted."""
    for node in graph:
        if node.parallel_foreach and not all(
            graph[out].parallel_step
            for out in node.out_funcs if out in graph
        ):
            _err(
                "Step *%s* uses self.next(num_parallel=...) but its "
                "target is not a gang (@parallel) step." % node.name,
                node,
            )


@linter.check
def check_parallel_foreach_calls_parallel_step(graph):
    """Reference parity (lint.py:475-489): a step carrying an explicit
    @parallel/@gpu_parallel decorator must be entered via
    self.next(num_parallel=...) — a gang body reached by a plain
    transition would silently run un-ganged."""
    gang_decos = {"parallel", "gpu_parallel"}
    for node in graph:
        is_gang = node.parallel_step or any(
            getattr(d, "name", None) in gang_decos
            for d in (node.decorators or [])
        )
        if not is_gang:
            continue
        # EVERY entry into a gang body must be a num_parallel transition
        # (reference validates all in_funcs of a parallel_step)
        callers = [
            n.name for n in graph
            if node.name in (n.out_funcs or []) and not n.parallel_foreach
        ]
        if callers:
            _err(
                "Step *%s* is a gang (@parallel) step but is entered from "
                "%s without self.next(num_parallel=...)."
                % (node.name, ", ".join(sorted(callers))),
                node,
            )


@linter.check
def check_join_followed_by_parallel_step(graph):
    """Reference parity (lint.py:458-472): the step AFTER a gang must be
    a join — every rank produced a task, something must collect them."""
    for node in graph:
        if node.parallel_step:
            for out in node.out_funcs:
                if out in graph and graph[out].type != "join":
                    _err(
                        "A gang (@parallel) step must be followed by a "
                        "join; step *%s* follows gang step *%s* but takes "
                        "no `inputs` argument." % (out, node.name),
                        node,
                    )


def lint(graph):
    linter.run_checks(graph)
