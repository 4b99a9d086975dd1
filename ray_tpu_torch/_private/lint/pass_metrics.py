"""TPU401/TPU402/TPU403 — metrics & span hygiene.

- TPU401: ``Counter``/``Gauge``/``Histogram`` constructed inside a
  function. The registry now tolerates re-registration (same shape
  returns the live instance) but every call still pays lock + shape
  verification on a hot path, and a tag/shape drift turns into a
  runtime ValueError at the call site instead of import time. Metrics
  belong at module scope.
- TPU402: a span context manager (``tracing.span``/``thread_trace``/
  ``activate``/``train.step_span``/``torch_profile``) called bare —
  without ``with`` or ``enter_context(...)`` — constructs the CM and
  drops it unentered: the span silently never records.
- TPU403: unbounded-cardinality metric labels — a request/session/
  trace id or uuid-shaped value used as a metric tag. Every distinct
  label value is a new time series held forever by the registry and
  shipped on every scrape; one busy serve deployment tagged by
  request_id is an OOM with a delay fuse. Per-request identity belongs
  on span attributes (ring-bounded), never on metric labels. Fires on
  metric constructors whose ``tag_keys`` name an id-shaped key, and on
  ``.inc/.set/.observe(..., tags={...})`` calls whose tag keys or
  values are id-shaped (including uuid calls, f-strings and str()/
  subscript wrappers around id-shaped names).
"""

from __future__ import annotations

import ast
import re

from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name

_METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram"})
# Identifier fragments that signal per-request/per-session cardinality.
_UNBOUNDED_RE = re.compile(
    r"request[_-]?id|session[_-]?id|trace[_-]?id|span[_-]?id|"
    r"correlation[_-]?id|task[_-]?id|uuid|guid",
    re.IGNORECASE,
)
_METRIC_METHODS = frozenset({"inc", "set", "observe"})
_SPAN_CMS = frozenset({
    "span", "step_span", "thread_trace", "activate", "torch_profile",
})
_SPAN_RECEIVERS = ("tracing", "train", "telemetry", "trace")


def _metric_ctor(call: ast.Call) -> str | None:
    func = call.func
    if isinstance(func, ast.Name) and func.id in _METRIC_CTORS:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in _METRIC_CTORS:
        recv = dotted_name(func.value)
        if recv and "metric" in recv.split(".")[-1].lower():
            return func.attr
    return None


def _unbounded_expr(node: ast.AST, depth: int = 0) -> str | None:
    """A human-readable description of why ``node`` smells like an
    unbounded id, or None. Unwraps the idioms ids hide in: uuid calls,
    str()/format() coercion, f-strings, and `[:16]`-style slicing."""
    if depth > 4 or node is None:
        return None
    name = dotted_name(node)
    if name and _UNBOUNDED_RE.search(name.split(".")[-1]):
        return name
    if isinstance(node, ast.Call):
        fname = dotted_name(node.func)
        if "uuid" in fname.lower():
            return f"{fname}(...)"
        if isinstance(node.func, ast.Name) and node.func.id in (
            "str", "repr", "format"
        ):
            for arg in node.args:
                hit = _unbounded_expr(arg, depth + 1)
                if hit:
                    return hit
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
            "format", "hex", "lower", "upper", "strip"
        ):
            hit = _unbounded_expr(node.func.value, depth + 1)
            if hit:
                return hit
            for arg in node.args:
                hit = _unbounded_expr(arg, depth + 1)
                if hit:
                    return hit
    if isinstance(node, ast.JoinedStr):
        for v in node.values:
            if isinstance(v, ast.FormattedValue):
                hit = _unbounded_expr(v.value, depth + 1)
                if hit:
                    return hit
    if isinstance(node, ast.Subscript):
        return _unbounded_expr(node.value, depth + 1)
    if isinstance(node, ast.Attribute):
        # dotted_name already failed (call/subscript in the chain):
        # inspect the final attribute name, then whatever it hangs off
        # (uuid.uuid4().hex reaches here as Attribute-over-Call).
        if _UNBOUNDED_RE.search(node.attr):
            return node.attr
        return _unbounded_expr(node.value, depth + 1)
    return None


def _tag_keys_hit(call: ast.Call) -> str | None:
    """An id-shaped string constant inside a ctor's tag_keys=(...)."""
    for kw in call.keywords:
        if kw.arg != "tag_keys":
            continue
        if isinstance(kw.value, (ast.Tuple, ast.List)):
            for elt in kw.value.elts:
                if (
                    isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)
                    and _UNBOUNDED_RE.search(elt.value)
                ):
                    return elt.value
    return None


def _tags_dict_hit(call: ast.Call) -> str | None:
    """An id-shaped key or value inside a record call's tags={...}."""
    for kw in call.keywords:
        if kw.arg != "tags" or not isinstance(kw.value, ast.Dict):
            continue
        for k, v in zip(kw.value.keys, kw.value.values):
            if (
                isinstance(k, ast.Constant)
                and isinstance(k.value, str)
                and _UNBOUNDED_RE.search(k.value)
            ):
                return f"key {k.value!r}"
            hit = _unbounded_expr(v)
            if hit:
                return f"value `{hit}`"
    return None


def _span_cm(call: ast.Call) -> str | None:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _SPAN_CMS:
        recv = dotted_name(func.value)
        last = recv.split(".")[-1].lower() if recv else ""
        if any(h in last for h in _SPAN_RECEIVERS):
            return f"{recv}.{func.attr}"
    elif isinstance(func, ast.Name) and func.id in ("step_span",
                                                    "thread_trace"):
        return func.id
    return None


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext):
        super().__init__(ctx)
        # Call nodes that ARE properly entered: with-items and
        # enter_context(...) arguments.
        self._entered: set[int] = set()
        manually_entered: set[str] = set()
        for node in ctx.nodes:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    self._entered.add(id(item.context_expr))
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name.endswith("enter_context"):
                    for arg in node.args:
                        self._entered.add(id(arg))
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "__enter__"
                        and isinstance(node.func.value, ast.Name)):
                    manually_entered.add(node.func.value.id)
        # `s = tracing.span(...)` followed by `s.__enter__()` IS
        # entered — whether the pairing balances on every path is
        # TPU404's (path-sensitive) question, not TPU402's.
        for node in ctx.nodes:
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id in manually_entered
                    and isinstance(node.value, ast.Call)):
                self._entered.add(id(node.value))

    def visit_Call(self, node: ast.Call):
        ctor = _metric_ctor(node)
        if ctor is not None and self.in_function:
            self.ctx.report(
                "TPU401", node,
                f"`{ctor}` constructed inside a function: registry "
                "lookup + shape check on every call, and shape drift "
                "becomes a runtime error here instead of import time — "
                "hoist to module scope",
                scope=self.scope,
            )
        if ctor is not None:
            hit = _tag_keys_hit(node)
            if hit is not None:
                self.ctx.report(
                    "TPU403", node,
                    f"`{ctor}` declares id-shaped tag key {hit!r}: "
                    "every distinct value is a permanent time series "
                    "(unbounded cardinality) — put per-request identity "
                    "on span attributes, not metric labels",
                    scope=self.scope,
                )
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_METHODS
        ):
            hit = _tags_dict_hit(node)
            if hit is not None:
                self.ctx.report(
                    "TPU403", node,
                    f"metric `.{node.func.attr}()` tagged with "
                    f"id-shaped {hit}: every distinct value is a "
                    "permanent time series (unbounded cardinality) — "
                    "put per-request identity on span attributes, not "
                    "metric labels",
                    scope=self.scope,
                )
        cm = _span_cm(node)
        if cm is not None and id(node) not in self._entered:
            self.ctx.report(
                "TPU402", node,
                f"`{cm}(...)` called without `with` (or "
                "`enter_context`): the context manager is never "
                "entered, so the span never records",
                scope=self.scope,
            )
        self.generic_visit(node)


_GATE_TOKENS = ("Counter", "Gauge", "Histogram", "span(", "thread_trace",
                "activate(", "torch_profile(", "tags")


def run(ctx: FileContext):
    # Every reportable shape carries one of these tokens textually:
    # metric ctors their class name, span CMs their method name plus
    # the opening paren of the call, and the .inc/.set/.observe label
    # check its `tags=` keyword.
    if not any(t in ctx.source for t in _GATE_TOKENS):
        return None
    _Visitor(ctx).visit(ctx.tree)
    return None


def finalize(states):
    return []
