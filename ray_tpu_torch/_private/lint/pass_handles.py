"""TPU104 — dropped collective handle.

The async verbs (``allreduce_async`` and friends,
``BucketStream.sync_async``) return a :class:`CollectiveWork` whose op
is already in flight. A handle that is never ``wait()``ed is a
*silently lost collective*: the op completes (or faults) and nobody
observes the result or the typed error — the overlap analogue of a
swallowed exception. Three path-sensitive shapes:

- **discarded**: ``g.allreduce_async(t)`` as a bare expression
  statement — the handle is unreachable the moment it is created.
- **never waited**: assigned to a local that reaches a ``return``/
  fall-off exit with no ``wait()`` on that path.
- **overwritten while pending**: the variable is re-bound to a new
  ``*_async`` handle (including by the next loop iteration) while the
  previous handle was never waited.

Escapes are forgiven: a handle that is returned, passed to a call,
or stored into an attribute/container is some other code's to join —
the runtime leak reporter (``sanitize.watch_work``) is the dynamic
backstop there. ``raise`` exits are also forgiven: abandoning in-flight
work on the error path is the documented destroy semantics."""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import dataflow
from ray_tpu_torch._private.lint.core import FileContext, iter_tree

ASYNC_VERBS = frozenset({
    "allreduce_async", "reducescatter_async", "allgather_async",
    "sync_async",
})

_PENDING = "pending"
_WAITED = "waited"
_ESCAPED = "escaped"
_RANKS = {_WAITED: 0, _PENDING: 1, _ESCAPED: 2}


def _handle_call(node: ast.AST) -> str | None:
    """The async verb name when ``node`` is directly a handle-creating
    call, else None."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name) and func.id in ASYNC_VERBS:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in ASYNC_VERBS:
        return func.attr
    return None


class _State(dataflow.PathState):
    __slots__ = ("vars",)

    def __init__(self):
        # name -> (status, open_line, verb)
        self.vars: dict[str, tuple] = {}

    def fork(self):
        st = _State()
        st.vars = dict(self.vars)
        return st

    def merge(self, other):
        for name, rec in other.vars.items():
            mine = self.vars.get(name)
            if mine is None or _RANKS[rec[0]] > _RANKS[mine[0]]:
                self.vars[name] = rec


class _Walker(dataflow.FlowWalker):
    def __init__(self, ctx: FileContext, scope: str, fn_node=None):
        self.ctx = ctx
        self.scope = scope
        self._reported: set[tuple] = set()
        # `global X; X = ..._async()` escapes: module state outlives
        # this function's paths.
        self._globals: set[str] = set()
        if fn_node is not None:
            for n in iter_tree(fn_node):
                if isinstance(n, (ast.Global, ast.Nonlocal)):
                    self._globals.update(n.names)

    # --------------------------------------------------------- reporting
    def _report(self, key, line, message):
        if key in self._reported:
            return
        self._reported.add(key)
        self.ctx.report(
            "TPU104", _node(line), message, scope=self.scope)

    # ----------------------------------------------------------- events
    def on_stmt(self, stmt, state):
        if isinstance(stmt, ast.Expr):
            verb = _handle_call(stmt.value)
            if verb is not None:
                self._report(
                    ("discard", stmt.value.lineno),
                    stmt.value.lineno,
                    f"result of `{verb}(...)` discarded: the op is in "
                    "flight but its handle is unreachable — the result "
                    "(and any typed fault) is silently dropped; "
                    "`wait()` it or keep the handle",
                )

    def on_assign(self, stmt, state):
        if not isinstance(stmt, ast.Assign):
            return
        targets = stmt.targets
        if len(targets) != 1:
            self._escape_names(stmt.value, state)
            return
        target = targets[0]
        verb = _handle_call(stmt.value)
        if isinstance(target, ast.Name):
            if target.id in self._globals:
                self._escape_names(stmt.value, state)
                return
            prev = state.vars.get(target.id)
            if prev is not None and prev[0] == _PENDING:
                self._report(
                    ("overwrite", stmt.lineno, target.id),
                    stmt.lineno,
                    f"`{target.id}` rebound while its previous "
                    f"`{prev[2]}` handle (line {prev[1]}) is still "
                    "pending: the in-flight op's result is silently "
                    "dropped — wait() the old handle first (or collect "
                    "handles in a list)",
                )
            if verb is not None:
                state.vars[target.id] = (_PENDING, stmt.lineno, verb)
                return
            if isinstance(stmt.value, ast.Name):
                # alias move: g = h transfers ownership
                src = state.vars.pop(stmt.value.id, None)
                if src is not None:
                    state.vars[target.id] = src
                    return
            state.vars.pop(target.id, None)
            return
        # attribute / subscript / tuple target: whatever names feed the
        # RHS escape, and a directly-created handle escapes too.
        self._escape_names(stmt.value, state)

    def on_call(self, call, state):
        func = call.func
        # h.wait() / h.wait(timeout_s=...) marks the handle joined.
        if isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name):
            name = func.value.id
            if name in state.vars:
                if func.attr == "wait":
                    rec = state.vars[name]
                    state.vars[name] = (_WAITED, rec[1], rec[2])
                return
        # A pending handle passed as an argument escapes (anywhere in
        # the argument expression — lists of handles included).
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            self._escape_names(arg, state)

    def on_exit(self, state, node, kind):
        if kind == "return":
            ret = getattr(node, "value", None)
            if ret is not None:
                self._escape_names(ret, state)
        if kind in ("raise", "break", "continue"):
            return
        for name, (status, line, verb) in state.vars.items():
            if status == _PENDING:
                self._report(
                    ("unwaited", line, name),
                    line,
                    f"`{name} = {verb}(...)` handle is never "
                    "`wait()`ed on a path reaching function exit: the "
                    "dispatched collective's result and typed errors "
                    "are lost (SPMD peers may be left joining an op "
                    "nobody observes)",
                )

    # ---------------------------------------------------------- helpers
    def _escape_names(self, expr, state):
        if expr is None:
            return
        for n in iter_tree(expr):
            if isinstance(n, ast.Name) and n.id in state.vars:
                rec = state.vars[n.id]
                state.vars[n.id] = (_ESCAPED, rec[1], rec[2])


def _node(line: int):
    class N:
        lineno = line
        col_offset = 0
    return N


def run(ctx: FileContext):
    if "_async" not in ctx.source:
        return None
    mi = dataflow.index(ctx)
    for info in mi.functions.values():
        scope = (f"{info.class_name}.{info.node.name}"
                 if info.class_name else info.node.name)
        walker = _Walker(ctx, scope, info.node)
        walker.walk_function(info.node, _State())
    return None


def finalize(states):
    return []
