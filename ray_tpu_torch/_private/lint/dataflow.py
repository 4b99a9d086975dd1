"""tpulint interprocedural dataflow engine.

Three layers, each consumed by the flow-sensitive passes
(TPU103/TPU104/TPU203/TPU204/TPU404):

- :class:`ModuleIndex` — one parsed file's symbol table: function
  definitions by qualname (``Class.method`` / ``module.func``, the
  same unification TPU202 uses), the import map (``from a import x``
  → ``x`` belongs to module ``a``), and every resolvable call site per
  function. Built once per file and cached on the
  :class:`~ray_tpu_torch._private.lint.core.FileContext` so the five passes
  share one walk.
- :class:`Program` — the module indexes stitched into a program-level
  call graph with ``closure()`` (which functions transitively reach a
  seed set — how TPU103 finds *wrapped* collectives) and reverse
  edges (how ``--changed`` finds interprocedural neighbors).
- :class:`FlowWalker` — a small abstract interpreter over function
  bodies: branch-forking ``if``/``else``, loop bodies walked twice (so
  a fact established at the bottom of a loop is visible at its top —
  the overwritten-while-pending shape), ``try`` bodies feeding their
  handlers the merged mid-body state (exception paths see every prefix
  of the protected region), and early exits (``return``/``raise``/
  ``break``/``continue``) delivered to an ``on_exit`` hook. Passes
  subclass it with their own :class:`PathState`.

The engine is still a *linter's* dataflow: names are unified
syntactically (``self.x`` → ``Class.x``), not through object identity,
and containers collapse to one summary node per container. Precision
comes from the pragma escape hatch; soundness comes from the runtime
sanitizer twins in ``ray_tpu_torch/_private/sanitize.py``.
"""

from __future__ import annotations

import ast
import dataclasses

from ray_tpu_torch._private.lint.core import FileContext, dotted_name, iter_tree, iter_children

# --------------------------------------------------------------------------
# Module indexing
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CallSite:
    """One resolvable call: ``callee`` is the program-level qualname
    (``Class.method`` or ``module.func``), ``node`` the ast.Call."""

    callee: str
    node: ast.Call


@dataclasses.dataclass
class FunctionInfo:
    qual: str                     # "Class.method" | "module.func"
    node: ast.AST                 # FunctionDef | AsyncFunctionDef
    ctx: FileContext
    class_name: str | None
    params: list[str]
    calls: list[CallSite] = dataclasses.field(default_factory=list)

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)


class ModuleIndex:
    """Symbol table + call sites for one parsed module."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.module = ctx.module
        # `from a.b import x as y` → imports["y"] == "b" (tail module):
        # the same tail-module unification TPU202 established, so a
        # name reached through an import collides with its definition.
        self.imports: dict[str, str] = {}
        # import a.b.c as m → module_aliases["m"] == "c"
        self.module_aliases: dict[str, str] = {}
        self.functions: dict[str, FunctionInfo] = {}
        # qualified var/attr name -> class name, from `x = Klass(...)`
        # assignments (one level of "type inference" so `x.method()`
        # resolves — enough for the singleton/member idiom this
        # codebase uses everywhere).
        self.var_types: dict[str, str] = {}
        self._collect_imports(ctx.tree)
        self._collect_types(ctx.tree)
        self._collect_functions(ctx.tree)

    # ------------------------------------------------------------- imports
    def _collect_imports(self, tree: ast.Module) -> None:
        for node in self.ctx.nodes:
            if isinstance(node, ast.ImportFrom) and node.module:
                src = node.module.split(".")[-1]
                for alias in node.names:
                    if alias.name != "*":
                        self.imports[alias.asname or alias.name] = src
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    tail = alias.name.split(".")[-1]
                    self.module_aliases[
                        alias.asname or alias.name.split(".")[0]
                    ] = tail

    # -------------------------------------------------------------- types
    def _collect_types(self, tree: ast.Module) -> None:
        def walk(node, class_name):
            for child in iter_children(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name)
                    continue
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    walk(child, class_name)
                    continue
                if isinstance(child, ast.Assign) and isinstance(
                        child.value, ast.Call):
                    fname = dotted_name(child.value.func)
                    tail = fname.split(".")[-1] if fname else ""
                    if not tail or not tail[0].isupper():
                        continue
                    for target in child.targets:
                        tname = dotted_name(target)
                        if tname:
                            self.var_types[
                                self.qualify(tname, class_name)] = tail
                else:
                    walk(child, class_name)

        walk(tree, None)

    # ----------------------------------------------------------- functions
    def _collect_functions(self, tree: ast.Module) -> None:
        def walk(node, class_name: str | None):
            for child in iter_children(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    if class_name:
                        qual = f"{class_name}.{child.name}"
                    else:
                        qual = f"{self.module}.{child.name}"
                    params = [a.arg for a in child.args.args
                              + child.args.posonlyargs
                              + child.args.kwonlyargs]
                    info = FunctionInfo(
                        qual=qual, node=child, ctx=self.ctx,
                        class_name=class_name, params=params,
                    )
                    # Innermost wins on duplicate quals (overloads by
                    # TYPE_CHECKING etc.) — harmless for a linter.
                    self.functions[qual] = info
                    self._collect_calls(info)
                    walk(child, class_name)  # nested defs keep class

        walk(tree, None)

    def _collect_calls(self, info: FunctionInfo) -> None:
        for node in iter_tree(info.node):
            if not isinstance(node, ast.Call):
                continue
            callee = self.resolve_call(node, info.class_name)
            if callee is not None:
                info.calls.append(CallSite(callee=callee, node=node))

    # ------------------------------------------------------------ resolve
    def resolve_call(self, call: ast.Call,
                     class_name: str | None) -> str | None:
        """Program-level qualname of the callee, or None when the target
        is dynamic (subscripts, call results, foreign attributes)."""
        func = call.func
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name):
                base = func.value.id
                if base in ("self", "cls"):
                    if class_name:
                        return f"{class_name}.{func.attr}"
                    return None
                if base in self.module_aliases:
                    return f"{self.module_aliases[base]}.{func.attr}"
                if base in self.imports:
                    # `from pkg import mod` then `mod.fn()` — attribute
                    # off an imported *module* name.
                    return f"{base}.{func.attr}"
            # one level of type inference: `f = Flusher(...)` then
            # `f.flush()` (or `self._f.flush()`) resolves to
            # Flusher.flush.
            recv = dotted_name(func.value)
            if recv:
                cls = self.var_types.get(self.qualify(recv, class_name))
                if cls:
                    return f"{cls}.{func.attr}"
            return None
        if isinstance(func, ast.Name):
            src = self.imports.get(func.id, self.module)
            return f"{src}.{func.id}"
        return None

    def qualify(self, name: str, class_name: str | None) -> str:
        """Unify a dotted value name program-wide (the TPU202 lock
        convention): ``self.x`` → ``Class.x``; imported → ``src.x``;
        bare → ``module.x``."""
        parts = name.split(".")
        if parts[0] in ("self", "cls") and class_name:
            return f"{class_name}.{'.'.join(parts[1:])}"
        if parts[0] in self.imports:
            return f"{self.imports[parts[0]]}.{name}"
        if parts[0] in self.module_aliases:
            tail = self.module_aliases[parts[0]]
            return f"{tail}.{'.'.join(parts[1:])}"
        return f"{self.module}.{name}"


def index(ctx: FileContext) -> ModuleIndex:
    """Shared per-file index, cached on the context: five passes, one
    symbol-table walk."""
    cached = getattr(ctx, "_df_index", None)
    if cached is None:
        cached = ModuleIndex(ctx)
        ctx._df_index = cached
    return cached


# --------------------------------------------------------------------------
# Program: cross-module call graph
# --------------------------------------------------------------------------


class Program:
    """The analyzed file set as one call graph."""

    def __init__(self, indexes):
        self.indexes: list[ModuleIndex] = list(indexes)
        self.functions: dict[str, FunctionInfo] = {}
        self.calls: dict[str, set[str]] = {}
        self.callers: dict[str, set[str]] = {}
        for mi in self.indexes:
            for qual, info in mi.functions.items():
                self.functions.setdefault(qual, info)
                edges = self.calls.setdefault(qual, set())
                for cs in info.calls:
                    edges.add(cs.callee)
                    self.callers.setdefault(cs.callee, set()).add(qual)

    def closure(self, seeds: set[str]) -> set[str]:
        """Functions that transitively CALL INTO ``seeds`` (callers of
        callers …), including the seeds themselves. Fixpoint over the
        reverse edges — how "this helper eventually issues a
        collective" propagates outward."""
        out = set(seeds)
        frontier = list(seeds)
        while frontier:
            fn = frontier.pop()
            for caller in self.callers.get(fn, ()):
                if caller not in out:
                    out.add(caller)
                    frontier.append(caller)
        return out


# --------------------------------------------------------------------------
# Flow-sensitive walker
# --------------------------------------------------------------------------


class PathState:
    """Base abstract state; passes subclass. ``fork()`` must deep-copy
    anything mutated; ``merge()`` joins two paths in place."""

    def fork(self) -> "PathState":  # pragma: no cover - interface
        raise NotImplementedError

    def merge(self, other: "PathState") -> None:  # pragma: no cover
        raise NotImplementedError


class FlowWalker:
    """Structured abstract interpreter over one function body.

    Subclass hooks (all optional):

    - ``on_stmt(stmt, state)`` — every statement before dispatch.
    - ``on_assign(stmt, state)`` / ``on_call(call, state)`` /
      ``on_await(node, state)`` — events in evaluation order.
    - ``on_branch(test, state, taken)`` — entering an ``if`` arm;
      ``taken`` is False for the else arm.
    - ``on_with(item, state, is_async)`` → optional token;
      ``on_with_exit(token, state)`` after the body.
    - ``on_exit(state, node, kind)`` — ``kind`` in {"return", "raise",
      "break", "continue", "fall"}; called once per explicit exit and
      once at the fall-off-the-end join.

    The walker returns None from a body walk when every path exited.
    Loop bodies are walked twice so facts from iteration N reach
    iteration N+1; ``try`` handlers start from the merge of every
    mid-body state (any prefix of the body may have run when the
    exception fired).
    """

    def walk_function(self, fn_node, state: PathState) -> None:
        self._finally_depth = 0
        self._finally_stack: list[list] = []
        end = self._walk_body(fn_node.body, state)
        if end is not None:
            self.on_exit(end, fn_node, "fall")

    def _run_pending_finallys(self, state):
        """An explicit exit inside ``try`` suites runs every enclosing
        ``finally`` before leaving — cleanups there must count."""
        pending, self._finally_stack = self._finally_stack, []
        try:
            for fb in reversed(pending):
                if state is None:
                    break
                self._finally_depth += 1
                state = self._walk_body(fb, state)
                self._finally_depth -= 1
        finally:
            self._finally_stack = pending
        return state

    @property
    def in_finally(self) -> bool:
        """True while walking a ``finally`` suite — the one place a
        cleanup call is exception-safe without a ``with``."""
        return getattr(self, "_finally_depth", 0) > 0

    # ------------------------------------------------------------- hooks
    def on_stmt(self, stmt, state):  # pragma: no cover - default
        pass

    def on_assign(self, stmt, state):
        pass

    def on_call(self, call, state):
        pass

    def on_await(self, node, state):
        pass

    def on_branch(self, test, state, taken: bool):
        return None

    def on_branch_exit(self, token, state):
        pass

    def on_if_join(self, stmt, state, then_exited: bool,
                   else_exited: bool):
        """After an ``if``: ``state`` is the merged survivor (None when
        both arms exited). ``then_exited``/``else_exited`` say which
        arms left the function — the rank-dependent-early-exit shape."""
        pass

    def on_with(self, item, state, is_async: bool):
        return None

    def on_with_exit(self, token, state):
        pass

    def on_exit(self, state, node, kind: str):
        pass

    # ---------------------------------------------------------- traversal
    def _visit_calls(self, node, state) -> None:
        """Fire on_call/on_await for every call in an expression,
        skipping nested function/lambda bodies (they do not run
        here). Order is structural, not evaluation order — the current
        passes only need the set of calls on the path."""
        if node is None:
            return
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                self.on_call(n, state)
            elif isinstance(n, ast.Await):
                self.on_await(n, state)
            stack.extend(iter_children(n))

    def _walk_body(self, stmts, state):
        for stmt in stmts:
            if state is None:
                break
            state = self._walk_stmt(stmt, state)
        return state

    def _walk_stmt(self, stmt, state):
        self.on_stmt(stmt, state)

        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._visit_calls(getattr(stmt, "value", None)
                              or getattr(stmt, "exc", None), state)
            kind = "return" if isinstance(stmt, ast.Return) else "raise"
            state = self._run_pending_finallys(state)
            if state is not None:
                self.on_exit(state, stmt, kind)
            return None

        if isinstance(stmt, (ast.Break, ast.Continue)):
            kind = "break" if isinstance(stmt, ast.Break) else "continue"
            state = self._run_pending_finallys(state)
            if state is not None:
                self.on_exit(state, stmt, kind)
            return None

        if isinstance(stmt, ast.If):
            self._visit_calls(stmt.test, state)
            then_state = state.fork()
            t_token = self.on_branch(stmt.test, then_state, True)
            then_end = self._walk_body(stmt.body, then_state)
            if then_end is not None:
                self.on_branch_exit(t_token, then_end)
            else_state = state
            e_token = self.on_branch(stmt.test, else_state, False)
            else_end = self._walk_body(stmt.orelse, else_state)
            if else_end is not None:
                self.on_branch_exit(e_token, else_end)
            if then_end is None and else_end is None:
                out = None
            elif then_end is None:
                out = else_end
            elif else_end is None:
                out = then_end
            else:
                else_end.merge(then_end)
                out = else_end
            self.on_if_join(stmt, out, then_end is None, else_end is None)
            return out

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(stmt, ast.While):
                self._visit_calls(stmt.test, state)
            else:
                self._visit_calls(stmt.iter, state)
            # Two passes over the body: the second starts from the
            # first's end state, so "assigned at the bottom, observed
            # at the top" (handle overwritten next iteration) is seen.
            body_end = self._walk_body(stmt.body, state.fork())
            if body_end is not None:
                second = self._walk_body(stmt.body, body_end.fork())
                if second is not None:
                    body_end = second
            # Loop may run zero times: merge body-exit into fallthrough.
            if body_end is not None:
                state.merge(body_end)
            return self._walk_body(stmt.orelse, state)

        if isinstance(stmt, ast.Try):
            entry = state.fork()
            mid_states = [entry.fork()]
            if stmt.finalbody:
                self._finally_stack.append(stmt.finalbody)

            body_state = state
            for s in stmt.body:
                if body_state is None:
                    break
                body_state = self._walk_stmt(s, body_state)
                if body_state is not None:
                    mid_states.append(body_state.fork())

            # Handler entry: ANY prefix of the body may have completed.
            handler_entry = mid_states[0]
            for ms in mid_states[1:]:
                handler_entry.merge(ms)

            exits = []
            if body_state is not None:
                else_state = self._walk_body(stmt.orelse, body_state)
                if else_state is not None:
                    exits.append(else_state)
            for handler in stmt.handlers:
                h_end = self._walk_body(handler.body, handler_entry.fork())
                if h_end is not None:
                    exits.append(h_end)

            if stmt.finalbody:
                self._finally_stack.pop()
            if not exits:
                # Every path out of the try exited the function; the
                # finally still runs, walk it for its events.
                if stmt.finalbody:
                    self._finally_depth += 1
                    self._walk_body(stmt.finalbody, handler_entry.fork())
                    self._finally_depth -= 1
                return None
            out = exits[0]
            for e in exits[1:]:
                out.merge(e)
            if not stmt.finalbody:
                return out
            self._finally_depth += 1
            out = self._walk_body(stmt.finalbody, out)
            self._finally_depth -= 1
            return out

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            tokens = []
            for item in stmt.items:
                self._visit_calls(item.context_expr, state)
                tokens.append(self.on_with(
                    item, state, isinstance(stmt, ast.AsyncWith)))
            end = self._walk_body(stmt.body, state)
            if end is not None:
                for token in reversed(tokens):
                    self.on_with_exit(token, end)
            return end

        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._visit_calls(stmt.value, state)
            self.on_assign(stmt, state)
            return state

        if isinstance(stmt, ast.Expr):
            self._visit_calls(stmt.value, state)
            return state

        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # A nested definition does not execute here.
            return state

        # Anything else (Assert, Delete, Global, …): surface its calls.
        self._visit_calls(stmt, state)
        return state
