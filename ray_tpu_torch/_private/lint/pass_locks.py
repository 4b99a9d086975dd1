"""TPU201/TPU202 — lock discipline.

- TPU201: a blocking call (RPC, ``time.sleep``, subprocess, socket,
  ``.result()``, collective op) issued while a
  ``threading.Lock``/``RLock`` ``with``-block is open. Holding a head
  or node lock across a blocking call is how one slow peer stalls the
  whole control plane (and how a drain fan-out got delayed).
  (``await`` under a held threading lock is TPU203's — the async-lock
  discipline pass.)
- TPU202: cross-function lock-order cycles. Each file contributes a
  static lock-acquisition graph (lock held → lock acquired, including
  one level of call-graph propagation: ``self.foo()`` / module-level
  ``foo()`` resolved by name); cycles across the analyzed file set are
  reported once per strongly-connected component.

Lock detection is name-based (``self._lock``, ``_env_build_lock``,
``self._pool_lock(name)``): a lock that is not named like one is
invisible here — the runtime sanitizer (``ray_tpu_torch/_private/sanitize.py``)
is the dynamic backstop.
"""

from __future__ import annotations

import ast
import dataclasses

from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name
from ray_tpu_torch._private.lint.pass_collective import (
    COLLECTIVE_NAMES,
    _RECEIVER_HINTS,
)

_LOCKISH = ("lock", "mutex")
_RPC_RECEIVERS = ("conn", "client", "head", "node", "rpc", "peer", "stub")
_HTTP_RECEIVERS = ("http", "session", "client")
_SOCK_METHODS = frozenset({"connect", "accept", "recv", "recv_into",
                           "sendall"})
_SUBPROCESS_BLOCKING = frozenset({"run", "call", "check_call",
                                  "check_output", "Popen"})


def _lock_expr_name(expr: ast.AST) -> str | None:
    """Dotted name of a with-item that looks like a lock acquisition,
    else None. Handles `self._lock` and factory calls like
    `self._pool_lock(name)`."""
    target = expr.func if isinstance(expr, ast.Call) else expr
    name = dotted_name(target)
    if not name:
        return None
    last = name.split(".")[-1].lower()
    if any(t in last for t in _LOCKISH):
        return name
    return None


@dataclasses.dataclass
class _Loc:
    path: str
    line: int
    snippet: str
    allowed: bool  # TPU202 pragma present at this line


@dataclasses.dataclass
class LockState:
    """Per-file contribution to the cross-file lock graph."""
    # fn_qual → locks it acquires directly
    direct: dict[str, set[str]] = dataclasses.field(default_factory=dict)
    # fn_qual → called fn_quals (name-resolved within this file)
    calls: dict[str, set[str]] = dataclasses.field(default_factory=dict)
    # (held_lock, acquired_lock) → _Loc  (direct nested acquisition)
    edges: dict[tuple[str, str], _Loc] = dataclasses.field(
        default_factory=dict)
    # (fn_qual_callee, held_lock) → _Loc (call made while holding)
    held_calls: list[tuple[str, str, _Loc]] = dataclasses.field(
        default_factory=list)


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext):
        super().__init__(ctx)
        self.state = LockState()
        self._held: list[str] = []
        # `from a import _table_lock` → _table_lock belongs to module a:
        # references here must unify with a's own, or a cross-FILE
        # inversion could never close its cycle.
        self._imports: dict[str, str] = {}
        for node in ctx.nodes:
            if isinstance(node, ast.ImportFrom) and node.module:
                src = node.module.split(".")[-1]
                for alias in node.names:
                    if alias.name != "*":
                        self._imports[alias.asname or alias.name] = src

    # --------------------------------------------------- naming
    def _qualify(self, name: str) -> str:
        """self.X → Class.X; bare/module-dotted → module.X — so the
        same lock reached from two methods unifies into one node."""
        parts = name.split(".")
        if parts[0] in ("self", "cls") and self._class:
            return f"{self._class[-1]}.{'.'.join(parts[1:])}"
        if parts[0] in self._imports:
            return f"{self._imports[parts[0]]}.{name}"
        return f"{self.ctx.module}.{name}"

    def _fn_qual(self) -> str:
        if self._class and self._func:
            return f"{self._class[-1]}.{self._func[-1]}"
        if self._func:
            return f"{self.ctx.module}.{self._func[-1]}"
        return f"{self.ctx.module}.<module>"

    def _callee_qual(self, call: ast.Call) -> str | None:
        func = call.func
        if isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name) and func.value.id in ("self", "cls"):
            if self._class:
                return f"{self._class[-1]}.{func.attr}"
        elif isinstance(func, ast.Name):
            src = self._imports.get(func.id, self.ctx.module)
            return f"{src}.{func.id}"
        return None

    def _loc(self, node: ast.AST) -> _Loc:
        line = getattr(node, "lineno", 1)
        return _Loc(
            path=self.ctx.path,
            line=line,
            snippet=self.ctx.snippet(line),
            allowed=self.ctx.allowed(line, "TPU202"),
        )

    # --------------------------------------------------- blocking calls
    def _blocking_reason(self, call: ast.Call) -> str | None:
        name = dotted_name(call.func)
        if not name:
            return None
        head, _, method = name.rpartition(".")
        head_last = head.split(".")[-1].lower() if head else ""
        if name == "time.sleep" or name == "sleep":
            return "time.sleep"
        if method == "result":
            return f"`{name}()` (future/RPC wait)"
        if method == "call" and any(r in head_last for r in _RPC_RECEIVERS):
            return f"blocking RPC `{name}`"
        if method == "request" and any(
                r in head_last for r in _HTTP_RECEIVERS):
            return f"HTTP request `{name}`"
        if method == "urlopen" or name == "urlopen":
            return f"`{name}` (network I/O)"
        if head_last == "subprocess" and method in _SUBPROCESS_BLOCKING:
            return f"`{name}` (subprocess)"
        if name == "fcntl.flock" or method == "flock":
            return f"`{name}` (file lock)"
        if method in _SOCK_METHODS and "sock" in head_last:
            return f"socket op `{name}`"
        if method in COLLECTIVE_NAMES and (
                any(h in head_last for h in _RECEIVER_HINTS)):
            return f"collective op `{name}`"
        if not head and name in COLLECTIVE_NAMES:
            # Only with collective import context would a bare name be
            # certain; accept the name match here — fixtures and real
            # call sites both read `allreduce(...)`.
            return f"collective op `{name}`"
        return None

    # --------------------------------------------------- visitors
    def _visit_func(self, node):
        # A function DEFINED under a with-block does not run there.
        held, self._held = self._held, []
        super()._visit_func(node)
        self._held = held

    def visit_Lambda(self, node: ast.Lambda):
        held, self._held = self._held, []
        self.generic_visit(node)
        self._held = held

    def visit_With(self, node: ast.With):
        fn = self._fn_qual()
        acquired: list[str] = []
        for item in node.items:
            lock_name = _lock_expr_name(item.context_expr)
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            if lock_name is None:
                continue
            lock_id = self._qualify(lock_name)
            self.state.direct.setdefault(fn, set()).add(lock_id)
            for held in self._held:
                if held != lock_id:
                    self.state.edges.setdefault(
                        (held, lock_id), self._loc(node))
            self._held.append(lock_id)
            acquired.append(lock_id)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    # NOTE: `await` under a held threading lock moved to TPU203
    # (pass_async_locks) — the async-lock discipline pass owns every
    # event-loop/lock interaction now.

    def visit_Call(self, node: ast.Call):
        fn = self._fn_qual()
        callee = self._callee_qual(node)
        if callee is not None:
            self.state.calls.setdefault(fn, set()).add(callee)
            if self._held:
                loc = self._loc(node)
                for held in self._held:
                    self.state.held_calls.append((callee, held, loc))
        if self._held:
            reason = self._blocking_reason(node)
            if reason is not None:
                self.ctx.report(
                    "TPU201", node,
                    f"{reason} while holding `{self._held[-1]}`: move "
                    "the blocking call outside the critical section",
                    scope=self.scope,
                )
        self.generic_visit(node)


def run(ctx: FileContext):
    v = _Visitor(ctx)
    v.visit(ctx.tree)
    return v.state


# ------------------------------------------------------------ finalize
def _acquire_closure(states) -> dict[str, set[str]]:
    direct: dict[str, set[str]] = {}
    calls: dict[str, set[str]] = {}
    for st in states:
        for fn, locks in st.direct.items():
            direct.setdefault(fn, set()).update(locks)
        for fn, cs in st.calls.items():
            calls.setdefault(fn, set()).update(cs)
    closure = {fn: set(locks) for fn, locks in direct.items()}
    # Fixpoint over the (acyclic or not) call graph; bounded by the
    # total number of (fn, lock) pairs so recursion can't spin.
    changed = True
    while changed:
        changed = False
        for fn, cs in calls.items():
            got = closure.setdefault(fn, set())
            before = len(got)
            for c in cs:
                got.update(closure.get(c, ()))
            if len(got) != before:
                changed = True
    return closure


def _sccs(graph: dict[str, set[str]]) -> list[list[str]]:
    """Tarjan, iterative."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in graph:
                    continue
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))
    return out


def finalize(states):
    from ray_tpu_torch._private.lint.core import RULES, Violation

    closure = _acquire_closure(states)
    edges: dict[tuple[str, str], _Loc] = {}
    for st in states:
        for key, loc in st.edges.items():
            edges.setdefault(key, loc)
        for callee, held, loc in st.held_calls:
            for lock in closure.get(callee, ()):
                if lock != held:
                    edges.setdefault((held, lock), loc)

    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    violations = []
    for comp in _sccs(graph):
        comp_set = set(comp)
        comp_edges = sorted(
            (k for k in edges
             if k[0] in comp_set and k[1] in comp_set),
            key=lambda k: (edges[k].path, edges[k].line),
        )
        anchor = next(
            (k for k in comp_edges if not edges[k].allowed), None)
        if anchor is None:
            continue  # every contributing edge is pragma'd
        loc = edges[anchor]
        cycle = " -> ".join(comp + [comp[0]])
        violations.append(Violation(
            rule="TPU202",
            name=RULES["TPU202"],
            path=loc.path,
            line=loc.line,
            col=0,
            message=(
                f"lock-order cycle {cycle}: two threads taking these "
                "locks in opposite orders deadlock; pick one global "
                "order"
            ),
            scope="|".join(comp),
            snippet=loc.snippet,
        ))
    return violations
