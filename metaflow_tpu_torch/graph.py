"""Static DAG builder: parses the AST of a FlowSpec subclass, no execution.

Reference behavior: metaflow/graph.py (DAGNode:95, FlowGraph:333). The graph is
derived purely from the class source — each @step method's trailing
`self.next(...)` call determines its out-edges and split type. Node types:

  start / linear / split / split-switch / foreach / split-parallel / join / end

`split-parallel` is a foreach whose cardinality is a gang size (num_parallel):
one process per rank of a `torch.distributed` process group.
"""

import ast
import inspect
import textwrap
import json


def _ast_literal(node):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


def deindent_docstring(doc):
    if not doc:
        return ""
    return textwrap.dedent(doc).strip()


def walk_step_sources(flow_cls):
    """Yield (cls, class_ast, source_file, lineno_offset) for every MRO
    level of a flow class that defines @step methods, outermost subclass
    first (callers apply subclass-wins themselves). `lineno_offset` rebases
    the class AST's relative linenos to absolute file lines (the JAX
    package's static analyzer shares it with its graph builder, so their
    source locations never drift apart)."""
    for cls in inspect.getmro(flow_cls):
        if cls is object:
            continue
        # parsing a class costs a tokenize+compile of its whole source:
        # skip MRO levels that define no steps (FlowSpec itself, mixins)
        if not any(getattr(v, "is_step", False)
                   for v in vars(cls).values()):
            continue
        try:
            source_lines, class_lineno = inspect.getsourcelines(cls)
            source_file = inspect.getsourcefile(cls)
        except (OSError, TypeError):
            continue
        tree = ast.parse(textwrap.dedent("".join(source_lines))).body
        if not tree or not isinstance(tree[0], ast.ClassDef):
            continue
        # ast lineno 1 == the class def line
        yield cls, tree[0], source_file, class_lineno - 1


class DAGNode(object):
    def __init__(self, func_ast, decos, wrappers, doc, source_file, lineno):
        self.name = func_ast.name
        self._lineno_offset = lineno or 0
        self.func_lineno = func_ast.lineno + self._lineno_offset
        self.source_file = source_file
        self.decorators = decos
        self.wrappers = wrappers
        self.doc = deindent_docstring(doc)

        # these attributes are populated by _parse
        self.tail_next_lineno = 0
        self.type = None
        self.out_funcs = []
        self.has_tail_next = False
        self.invalid_tail_next = False
        self.num_args = 0
        self.foreach_param = None
        self.num_parallel = 0
        self.num_parallel_literal = False
        self.parallel_step = False
        self.condition = None
        self.switch_cases = {}
        self.parallel_foreach = False
        self._parse(func_ast)

        # these attributes are populated by FlowGraph._postprocess/_traverse
        self.in_funcs = set()
        self.split_parents = []
        self.matching_join = None

    def _expr_str(self, expr):
        return "%s.%s" % (expr.value.id, expr.attr)

    def _parse_switch_dict(self, dict_node):
        """Extract {literal_or_config_key: self.step} switch cases."""
        if not isinstance(dict_node, ast.Dict):
            return None
        cases = {}
        for key, value in zip(dict_node.keys, dict_node.values):
            case_key = None
            if isinstance(key, ast.Constant):
                case_key = key.value
            elif isinstance(key, ast.Attribute):
                # self.config.some_key → resolved at scheduling time
                if (
                    isinstance(key.value, ast.Attribute)
                    and isinstance(key.value.value, ast.Name)
                    and key.value.value.id == "self"
                ):
                    case_key = "config:%s.%s" % (key.value.attr, key.attr)
                else:
                    return None
            else:
                return None
            if not (
                isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id == "self"
            ):
                return None
            cases[case_key] = value.attr
        return cases or None

    def _parse(self, func_ast):
        self.num_args = len(func_ast.args.args)
        tail = func_ast.body[-1]

        # end step has no transition
        if self.name == "end":
            self.type = "end"

        # ensure the tail is an expression statement
        if not isinstance(tail, ast.Expr):
            return
        # determine the type of self.next transition
        try:
            if not self._expr_str(tail.value.func) == "self.next":
                return

            self.has_tail_next = True
            self.invalid_tail_next = True
            self.tail_next_lineno = tail.value.lineno + self._lineno_offset

            keywords = dict(
                (k.arg, k.value) for k in tail.value.keywords if k.arg is not None
            )

            # switch: self.next({...}, condition='var')
            if "condition" in keywords:
                cond = _ast_literal(keywords["condition"])
                if (
                    isinstance(cond, str)
                    and len(tail.value.args) == 1
                ):
                    cases = self._parse_switch_dict(tail.value.args[0])
                    if cases:
                        self.type = "split-switch"
                        self.condition = cond
                        self.switch_cases = cases
                        self.out_funcs = list(cases.values())
                        self.invalid_tail_next = False
                return

            self.out_funcs = [e.attr for e in tail.value.args]
            literal_kw = {k: _ast_literal(v) for k, v in keywords.items()}

            if len(keywords) == 1:
                if "foreach" in keywords:
                    if isinstance(literal_kw["foreach"], str):
                        self.type = "foreach"
                        self.foreach_param = literal_kw["foreach"]
                        self.invalid_tail_next = False
                elif "num_parallel" in keywords:
                    self.type = "split-parallel"
                    self.parallel_foreach = True
                    # cardinality may be a runtime expression; literal if
                    # given. num_parallel_literal distinguishes a literal 0
                    # (statically invalid) from a runtime expression
                    lit = literal_kw.get("num_parallel")
                    self.num_parallel = lit if isinstance(lit, int) else 0
                    self.num_parallel_literal = isinstance(lit, int)
                    self.invalid_tail_next = False
                return
            if len(keywords) == 0:
                if len(self.out_funcs) > 1:
                    self.type = "split"
                    self.invalid_tail_next = False
                elif len(self.out_funcs) == 1:
                    self.type = "linear"
                    self.invalid_tail_next = False
                return
        except AttributeError:
            return

    def __str__(self):
        return (
            "[%s (%s) type=%s out=%s]"
            % (self.name, self.func_lineno, self.type, ",".join(self.out_funcs))
        )


class StepVisitor(ast.NodeVisitor):
    def __init__(self, nodes, flow, source_file, lineno_offset=0):
        self.nodes = nodes
        self.flow = flow
        self.source_file = source_file
        # ast linenos are relative to the class source (line 1 == the
        # class def); the offset rebases them to absolute file lines so
        # lint/analysis findings carry editor-usable locations
        self.lineno_offset = lineno_offset
        super().__init__()

    def visit_FunctionDef(self, node):
        func = getattr(self.flow, node.name, None)
        if func and getattr(func, "is_step", False):
            # user decorators applied via @step wrappers
            wrappers = getattr(func, "wrappers", [])
            decos = getattr(func, "decorators", [])
            self.nodes[node.name] = DAGNode(
                node, decos, wrappers, func.__doc__, self.source_file,
                self.lineno_offset
            )


class FlowGraph(object):
    def __init__(self, flow):
        self.name = flow.__name__
        self.nodes = self._create_nodes(flow)
        self.doc = deindent_docstring(flow.__doc__)
        self._postprocess()
        self._traverse_graph()

    def _create_nodes(self, flow):
        nodes = {}
        for _cls, root, source_file, offset in walk_step_sources(flow):
            visitor = StepVisitor(nodes, flow, source_file,
                                  lineno_offset=offset)
            # only add steps not already defined by a subclass (MRO order)
            new_nodes = {}
            visitor.nodes = new_nodes
            visitor.visit(root)
            for name, node in new_nodes.items():
                nodes.setdefault(name, node)
        return nodes

    def _postprocess(self):
        # any node who has a foreach as any of its split parents
        # has a join that joins over that foreach
        for node in self.nodes.values():
            if node.type in ("linear", "end") and node.num_args > 1:
                node.type = "join"

    def _traverse_graph(self):
        # iterative DFS (explicit worklist): deep or generated graphs must
        # not hit Python's recursion limit during graph construction (the
        # linter's traversals are iterative for the same reason)
        if "start" not in self.nodes:
            return
        worklist = [("start", frozenset(), ())]
        while worklist:
            name, seen, split_parents = worklist.pop()
            node = self.nodes[name]
            # split-switch executes one branch only: no join expected, so
            # it does not open a split level
            if node.type in ("split", "foreach", "split-parallel"):
                node.split_parents = list(split_parents)
                split_parents = split_parents + (node.name,)
            elif node.type == "join":
                # ignore joins with empty split stacks (caught by the
                # linter)
                if split_parents:
                    node.split_parents = list(split_parents[:-1])
                    self.nodes[split_parents[-1]].matching_join = node.name
                    split_parents = split_parents[:-1]
            else:
                node.split_parents = list(split_parents)

            for n in node.out_funcs:
                child = self.nodes.get(n)
                if child is None:
                    continue
                child.in_funcs.add(name)
                if n not in seen:
                    worklist.append((n, seen | {n}, split_parents))

        # infer parallel_foreach propagation: the step(s) inside a
        # split-parallel are parallel steps
        for node in self.nodes.values():
            if node.type == "split-parallel":
                for n in node.out_funcs:
                    if n in self.nodes:
                        self.nodes[n].parallel_step = True

    def __getitem__(self, x):
        return self.nodes[x]

    def __contains__(self, x):
        return x in self.nodes

    def __iter__(self):
        return iter(self.nodes.values())

    def sorted_nodes(self):
        """Topological-ish order: BFS from start (cycles via switch allowed)."""
        order, seen = [], set()
        frontier = ["start"] if "start" in self.nodes else []
        while frontier:
            nxt = []
            for name in frontier:
                if name in seen or name not in self.nodes:
                    continue
                seen.add(name)
                order.append(name)
                nxt.extend(self.nodes[name].out_funcs)
            frontier = nxt
        # orphans last
        for name in self.nodes:
            if name not in seen:
                order.append(name)
        return order

    def output_dot(self):
        def edge(a, b):
            return '"%s" -> "%s";' % (a, b)

        lines = ["digraph %s {" % self.name]
        for node in self.nodes.values():
            shape = {
                "start": "oval",
                "end": "oval",
                "join": "invtriangle",
                "foreach": "triangle",
                "split-parallel": "triangle",
                "split": "diamond",
                "split-switch": "diamond",
            }.get(node.type, "box")
            lines.append('"%s" [shape=%s];' % (node.name, shape))
            for out in node.out_funcs:
                lines.append(edge(node.name, out))
        lines.append("}")
        return "\n".join(lines)

    def output_steps(self):
        """JSON-able structural description (reference: graph.py output_steps)."""
        steps = {}
        for node in self.nodes.values():
            steps[node.name] = {
                "type": node.type,
                "line": node.func_lineno,
                "doc": node.doc,
                "next": node.out_funcs,
                "foreach": node.foreach_param,
                "condition": node.condition,
                "switch_cases": node.switch_cases,
                "num_parallel": node.num_parallel,
                "matching_join": node.matching_join,
                "split_parents": node.split_parents,
                "decorators": [str(d) for d in node.decorators],
            }
        return steps

    def __str__(self):
        return json.dumps(self.output_steps(), indent=2)
