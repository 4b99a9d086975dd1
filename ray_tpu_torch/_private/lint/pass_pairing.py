"""TPU404 — unbalanced resource pairing (path-sensitive TPU402 big
sibling).

TPU402 catches a span CM that is never *entered*. TPU404 catches the
open/close pairs the dataflow engine can follow across paths:

- **``memory.track()`` discarded**: the Registration is unreachable
  the moment it is created — nobody can ever ``close()`` it, so the
  byte claim lives (and lies) until process exit. The registry
  tolerates re-tracking by tag, but an explicitly closeable claim is
  the difference between "replaced eventually" and "retired now".
- **``memory.track()`` not closed on a path**: assigned to a local
  that reaches a ``return``/fall-off exit without ``close()`` and
  without escaping (attr/container store, return, passed on). The
  weakref leak reporter (``sanitize.watch_registration``) is the
  runtime twin for the escaped ones.
- **manual span ``__enter__`` without exception-safe ``__exit__``**:
  ``s = tracing.span(...); s.__enter__()`` must ``__exit__`` on every
  path INCLUDING the exception path — i.e. in a ``finally`` (or just
  use ``with``). An exception between enter and exit otherwise leaves
  the span open forever and every subsequent span mis-parented.

``with`` usage is always clean — the pairing is structural there."""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import dataflow
from ray_tpu_torch._private.lint.core import FileContext, dotted_name, iter_tree

# Receivers that make a bare `.track(...)` the memory-ledger call.
_MEM_RECEIVERS = ("memory", "rmem", "_rmem", "mem")

_CM = "cm"               # span CM constructed, not yet entered
_OPEN = "open"           # registration created, not yet closed
_ENTERED = "entered"     # span CM manually __enter__'d
_CLOSED = "closed"
_ESCAPED = "escaped"
_RANK = {_CM: 0, _CLOSED: 0, _OPEN: 1, _ENTERED: 1, _ESCAPED: 2}


def _track_call(node: ast.AST, imported_track: bool) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name):
        return func.id == "track" and imported_track
    if isinstance(func, ast.Attribute) and func.attr == "track":
        recv = dotted_name(func.value)
        last = recv.split(".")[-1].lower() if recv else ""
        return any(last == h or last.endswith(h) for h in _MEM_RECEIVERS)
    return False


class _State(dataflow.PathState):
    __slots__ = ("vars",)

    def __init__(self):
        # name -> (status, open_line, kind, risky)
        # risky: a call happened while the resource was open — the
        # exception-path flag for manual __enter__.
        self.vars: dict[str, tuple] = {}

    def fork(self):
        st = _State()
        st.vars = dict(self.vars)
        return st

    def merge(self, other):
        for name, rec in other.vars.items():
            mine = self.vars.get(name)
            if mine is None or _RANK[rec[0]] > _RANK[mine[0]]:
                self.vars[name] = rec


class _Walker(dataflow.FlowWalker):
    def __init__(self, ctx: FileContext, scope: str, imported_track: bool,
                 fn_node=None):
        self.ctx = ctx
        self.scope = scope
        self.imported_track = imported_track
        self._reported: set[tuple] = set()
        # `global X; X = memory.track(...)` escapes — module-lifetime
        # claims are closed by whoever replaces them.
        self._globals: set[str] = set()
        if fn_node is not None:
            for n in iter_tree(fn_node):
                if isinstance(n, (ast.Global, ast.Nonlocal)):
                    self._globals.update(n.names)
        # names whose __exit__/close happened outside any finally while
        # calls could raise in between — flagged once per function
        self.unsafe_exits: dict[str, tuple] = {}

    def _report(self, key, line, message):
        if key in self._reported:
            return
        self._reported.add(key)
        self.ctx.report("TPU404", _node(line), message, scope=self.scope)

    # ----------------------------------------------------------- events
    def on_stmt(self, stmt, state):
        if isinstance(stmt, ast.Expr) and _track_call(
                stmt.value, self.imported_track):
            self._report(
                ("discard", stmt.value.lineno),
                stmt.value.lineno,
                "`memory.track(...)` result discarded: the "
                "Registration can never be `close()`d — the byte "
                "claim outlives its subsystem and the ledger lies; "
                "keep the handle (and close it) or use `with`",
            )

    def on_assign(self, stmt, state):
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            self._escape_names(getattr(stmt, "value", None), state)
            return
        target = stmt.targets[0]
        if isinstance(target, ast.Name):
            if target.id in self._globals:
                self._escape_names(stmt.value, state)
                return
            if _track_call(stmt.value, self.imported_track):
                state.vars[target.id] = (_OPEN, stmt.lineno,
                                         "registration", False)
                return
            from ray_tpu_torch._private.lint.pass_metrics import _span_cm
            if isinstance(stmt.value, ast.Call) and _span_cm(
                    stmt.value) is not None:
                state.vars[target.id] = (_CM, stmt.lineno, "span",
                                         False)
                return
            if isinstance(stmt.value, ast.Name):
                src = state.vars.pop(stmt.value.id, None)
                if src is not None:
                    state.vars[target.id] = src
                    return
            state.vars.pop(target.id, None)
            return
        self._escape_names(stmt.value, state)

    def on_call(self, call, state):
        func = call.func
        if isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name):
            name = func.value.id
            rec = state.vars.get(name)
            if rec is not None:
                if func.attr in ("close", "__exit__"):
                    state.vars[name] = (_CLOSED, rec[1], rec[2], rec[3])
                    if (rec[0] == _ENTERED and not self.in_finally
                            and rec[3]):
                        self.unsafe_exits.setdefault(
                            name, (rec[1], call.lineno))
                    return
                if func.attr == "__enter__":
                    # anchor at the enter, not the construction
                    state.vars[name] = (_ENTERED, call.lineno, rec[2],
                                        rec[3])
                    return
                if func.attr == "update" or func.attr == "add":
                    return
        # any other call while a resource is open can raise: mark risky
        for name, rec in list(state.vars.items()):
            if rec[0] in (_OPEN, _ENTERED) and not rec[3]:
                state.vars[name] = (rec[0], rec[1], rec[2], True)
        # resources passed onward escape
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            self._escape_names(arg, state)

    def on_with(self, item, state, is_async):
        # `with reg:` / `with memory.track(...) as reg:` is the clean
        # structural pairing; an as-bound name is managed.
        if item.optional_vars is not None and isinstance(
                item.optional_vars, ast.Name):
            state.vars.pop(item.optional_vars.id, None)
        if isinstance(item.context_expr, ast.Name):
            name = item.context_expr.id
            rec = state.vars.get(name)
            if rec is not None:
                state.vars[name] = (_CLOSED, rec[1], rec[2], rec[3])
        return None

    def on_exit(self, state, node, kind):
        if kind == "return":
            self._escape_names(getattr(node, "value", None), state)
        if kind in ("raise", "break", "continue"):
            return
        for name, (status, line, res_kind, risky) in state.vars.items():
            if status == _OPEN:
                self._report(
                    ("leak", line, name),
                    line,
                    f"`{name} = memory.track(...)` registration is "
                    "neither `close()`d nor stored on a path reaching "
                    "function exit: the byte claim leaks and the "
                    "device-memory ledger over-reports until process "
                    "exit",
                )
            elif status == _ENTERED:
                self._report(
                    ("enter-leak", line, name),
                    line,
                    f"`{name}.__enter__()` has no matching "
                    "`__exit__` on a path reaching function exit: the "
                    "span never closes and every later span "
                    "mis-parents — pair it in a `finally` or use "
                    "`with`",
                )

    def finish(self):
        for name, (open_line, close_line) in self.unsafe_exits.items():
            self._report(
                ("unsafe", open_line, name),
                open_line,
                f"`{name}.__enter__()` is `__exit__`ed only on the "
                f"happy path (line {close_line}, not in a `finally`): "
                "any exception raised in between leaves the span open "
                "— move the `__exit__` into a `finally` or use `with`",
            )

    # ---------------------------------------------------------- helpers
    def _escape_names(self, expr, state):
        if expr is None:
            return
        for n in iter_tree(expr):
            if isinstance(n, ast.Name) and n.id in state.vars:
                rec = state.vars[n.id]
                state.vars[n.id] = (_ESCAPED, rec[1], rec[2], rec[3])


def _node(line: int):
    class N:
        lineno = line
        col_offset = 0
    return N


def run(ctx: FileContext):
    src = ctx.source
    if "track" not in src and "__enter__" not in src:
        return None
    imported_track = False
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[-1] == "memory":
                for a in node.names:
                    if a.name == "track":
                        imported_track = True
    mi = dataflow.index(ctx)
    for info in mi.functions.values():
        scope = (f"{info.class_name}.{info.node.name}"
                 if info.class_name else info.node.name)
        walker = _Walker(ctx, scope, imported_track, info.node)
        walker.walk_function(info.node, _State())
        walker.finish()
    return None


def finalize(states):
    return []
