"""TPU601 — host↔device sync in a hot path.

A ``torch.cuda.synchronize()`` / ``Event.synchronize()`` / ``.cpu()`` /
``.tolist()`` / ``.item()`` / ``float(tensor)`` inside the step loop
stalls the launch queue: the host stops feeding the card, the stream
drains, and the step time grows by the full round trip. The pass is
REGION-based:

- a **compute-phase span body** (``with sp.phase("compute"):``) is the
  hottest region: every host-sync form fires there, including the weak
  ones (``float(x)`` / ``int(x)`` / ``np.asarray(x)``) that force an
  implicit transfer.
- a **step region** — the body of a ``with train.step_span():`` block or
  of a loop that drives step spans / ``report()`` (the codebase's two
  step-loop markers) — fires only on the explicit sync verbs
  (``synchronize`` / ``.cpu()`` / ``.tolist()`` / ``.item()``): a ``float()``
  on an already-host value is routine bookkeeping there.
- a **non-compute phase body** (``phase("collective")`` /
  ``phase("data_wait")`` / ``phase("checkpoint")``) is *shielded*:
  blocking is the declared semantics of those phases (that is where the
  tail join lives).

Reach is transitive: a call from a hot region into a helper that
(anywhere down the call graph) issues an explicit sync verb is flagged
at the call site — the engine's reverse closure, same as TPU103.
``wait()`` / ``wait_pending()`` calls are exempt everywhere: joining an
async CollectiveWork handle is the DESIGNED sync point of the overlap
machinery, not an accident."""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import dataflow
from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name, iter_tree

#: Explicit sync verbs (fire in any hot region, and seed the closure):
#: ``torch.cuda.synchronize()`` and a ``Stream``'s or ``Event``'s
#: ``synchronize()``, by any receiver.
STRONG_SYNCS = frozenset({"synchronize"})
#: Tensor methods that copy to the host and so wait for the stream, when
#: called without arguments (``.to("cpu")`` is left to the runtime).
STRONG_METHODS = frozenset({"item", "cpu", "tolist"})
#: The designed join points of the overlap machinery — never a finding,
#: and never followed into the closure.
WAIT_EXEMPT = frozenset({"wait", "wait_pending", "wait_all", "join"})
#: Callee tails that are end-of-step bookkeeping by design: the step
#: accounting itself may sample/sync, and flagging it would indict the
#: telemetry for existing.
_BOOKKEEPING_TAILS = frozenset({
    "report", "step_span", "finish_step", "implicit_step", "step_sample",
    "flush_observability",
})
_HOT_MARKERS = ("step_span", ".phase(", "report(")


def _sync_kind(call: ast.Call) -> str | None:
    """'synchronize'/'.item()'/'.cpu()'/'.tolist()' for strong syncs,
    'float()'/'int()'/'np.asarray()' for weak ones, else None."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr in STRONG_SYNCS:
            return func.attr
        if (func.attr in STRONG_METHODS and not call.args
                and not call.keywords):
            return f".{func.attr}()"
        if func.attr in ("asarray", "array"):
            recv = dotted_name(func.value)
            if recv.split(".")[-1] in ("np", "numpy"):
                return f"np.{func.attr}()"
        return None
    if isinstance(func, ast.Name):
        if func.id in STRONG_SYNCS:
            return func.id
        if func.id in ("float", "int") and len(call.args) == 1 \
                and not call.keywords and not isinstance(
                    call.args[0], ast.Constant):
            return f"{func.id}()"
    return None


def _is_weak(kind: str) -> bool:
    return kind in ("float()", "int()", "np.asarray()", "np.array()")


def _is_step_loop(node: ast.AST) -> bool:
    """A loop that drives the train-step machinery: its body contains a
    ``step_span``/``phase`` span entry or a ``report()`` call."""
    for child in iter_tree(node):
        if not isinstance(child, ast.Call):
            continue
        func = child.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if name in ("step_span", "report"):
            return True
    return False


def _phase_name(call: ast.Call) -> str | None:
    """'compute' / 'collective' / … for a ``*.phase("x")`` call."""
    func = call.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else "")
    if name != "phase" or not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return "?"


def _is_step_span_entry(call: ast.Call) -> bool:
    func = call.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else "")
    return name == "step_span"


# Region lattice: NONE < STEP < COMPUTE; SHIELDED masks everything.
_NONE, _STEP, _COMPUTE, _SHIELDED = 0, 1, 2, 3


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext, mi: dataflow.ModuleIndex,
                 st: "_PassState"):
        super().__init__(ctx)
        self.mi = mi
        self.st = st
        self._region: list[int] = [_NONE]

    # ------------------------------------------------------------ regions
    @property
    def region(self) -> int:
        return self._region[-1]

    def enter_function(self, node):
        # A nested def's body does not execute in the enclosing
        # region — it runs whenever it is called.
        self._region.append(_NONE)

    def exit_function(self, node):
        self._region.pop()

    def _with_region(self, region: int, body_visit) -> None:
        self._region.append(region)
        body_visit()
        self._region.pop()

    def _visit_with(self, node):
        region = None
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                ph = _phase_name(expr)
                if ph == "compute":
                    region = _COMPUTE
                elif ph is not None:
                    # Declared non-compute phase: blocking is its
                    # semantics (data_wait/collective/checkpoint).
                    region = _SHIELDED
                elif _is_step_span_entry(expr) and region is None:
                    region = _STEP
            self.visit(expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        if region is None:
            region = self.region

        def body():
            for stmt in node.body:
                self.visit(stmt)

        self._with_region(region, body)

    def visit_With(self, node):
        self._visit_with(node)

    def visit_AsyncWith(self, node):
        self._visit_with(node)

    def _visit_loop(self, node):
        self.visit(node.iter) if isinstance(
            node, (ast.For, ast.AsyncFor)) else self.visit(node.test)
        region = self.region
        if region == _NONE and _is_step_loop(node):
            region = _STEP

        def body():
            for stmt in node.body:
                self.visit(stmt)
            for stmt in node.orelse:
                self.visit(stmt)

        self._with_region(region, body)

    def visit_For(self, node):
        self._visit_loop(node)

    def visit_AsyncFor(self, node):
        self._visit_loop(node)

    def visit_While(self, node):
        self._visit_loop(node)

    # ------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call):
        region = self.region
        if region in (_NONE, _SHIELDED):
            self.generic_visit(node)
            return
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else ""
        if attr in WAIT_EXEMPT:
            self.generic_visit(node)
            return
        kind = _sync_kind(node)
        if kind is not None:
            if _is_weak(kind) and region != _COMPUTE:
                self.generic_visit(node)
                return
            where = ("inside a compute-phase span"
                     if region == _COMPUTE else "inside the step loop")
            self.ctx.report(
                "TPU601", node,
                f"host sync `{kind}` {where}: the host blocks on the "
                "device and the launch queue drains — every "
                "in-flight kernel behind it serializes. Move it out "
                "of the hot path, batch it per-N-steps, or annotate "
                "the blocking phase it belongs to",
                scope=self.scope,
            )
        else:
            callee = self.mi.resolve_call(
                node, self._class[-1] if self._class else None)
            if callee is not None and callee.split(
                    ".")[-1] not in _BOOKKEEPING_TAILS | WAIT_EXEMPT:
                self.st.events.append((
                    self.ctx, callee, node.lineno, region, self.scope))
        self.generic_visit(node)


class _PassState:
    def __init__(self, mi: dataflow.ModuleIndex):
        self.mi = mi
        # (ctx, callee, line, region, scope) — hot calls to resolve
        self.events: list[tuple] = []
        # fn qual -> sync kind for functions with a DIRECT strong sync
        self.direct: dict[str, str] = {}


def run(ctx: FileContext):
    src = ctx.source
    mi = dataflow.index(ctx)
    st = _PassState(mi)
    # Seed collection runs everywhere: a helper file with no hot region
    # of its own still taints its callers.
    if "synchronize" in src or any(
            f".{m}()" in src for m in STRONG_METHODS):
        for qual, info in mi.functions.items():
            if qual.split(".")[-1] in WAIT_EXEMPT:
                continue  # the designed join points never taint callers
            for node in iter_tree(info.node):
                if isinstance(node, ast.Call):
                    kind = _sync_kind(node)
                    if kind is not None and not _is_weak(kind):
                        st.direct[qual] = kind
                        break
    if any(m in src for m in _HOT_MARKERS):
        _Visitor(ctx, mi, st).visit(ctx.tree)
    return st


def finalize(states):
    program = dataflow.Program([st.mi for st in states])
    direct: dict[str, str] = {}
    for st in states:
        direct.update(st.direct)
    if not direct:
        return []
    issuers = program.closure(set(direct))
    seen: set[tuple] = set()
    for st in states:
        for ctx, callee, line, region, scope in st.events:
            if callee not in issuers or callee not in program.functions:
                continue
            key = (id(ctx), line, callee)
            if key in seen:
                continue
            seen.add(key)
            where = ("a compute-phase span" if region == _COMPUTE
                     else "the step loop")
            ctx.report(
                "TPU601", _FakeNode(line),
                f"`{callee}()` transitively reaches an explicit host "
                f"sync (synchronize/.item()/.cpu()/.tolist()) and is "
                f"called inside {where}: the helper stalls the "
                "launch queue from a hot region — hoist the sync "
                "out or make the helper take the async-handle path",
                scope=scope,
            )
    return []


class _FakeNode:
    __slots__ = ("lineno", "col_offset")

    def __init__(self, lineno: int, col: int = 0):
        self.lineno = lineno
        self.col_offset = col
