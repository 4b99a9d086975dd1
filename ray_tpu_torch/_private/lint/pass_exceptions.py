"""TPU301 — broad-except hygiene.

``except Exception: pass`` inside an RPC handler or daemon loop is how
poison flags, death fan-out, and drain notices get silently eaten
(the fault model assumes failures PROPAGATE). A broad handler is
fine if it re-raises, logs the exception, or carries an explicit
``# tpulint: allow(broad-except reason=…)`` pragma stating why
swallowing is the intent.
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name

_BROAD = ("Exception", "BaseException")
_LOG_METHODS = frozenset({
    "exception", "warning", "error", "critical", "info", "debug", "log",
})


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


def _is_log_call(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    if not name:
        return False
    if name.endswith("print_exc") or name == "warnings.warn":
        return True
    head, _, method = name.rpartition(".")
    return method in _LOG_METHODS and "log" in head.lower()


def _handles(handler: ast.ExceptHandler) -> bool:
    """True if the handler body re-raises or logs."""
    for node in _walk_body(handler.body):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and _is_log_call(node):
            return True
    return False


def _walk_body(body):
    """ast.walk over statements, NOT descending into nested function
    definitions — a `raise` inside a callback defined in the handler
    does not make the handler itself re-raise."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _Visitor(ScopeVisitor):
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if _is_broad(node) and not _handles(node):
            what = (
                "bare `except`" if node.type is None
                else "`except Exception`"
            )
            self.ctx.report(
                "TPU301", node,
                f"{what} neither re-raises nor logs — a swallowed "
                "failure here can mask death fan-out / poison flags; "
                "log it, narrow to a typed exception, or pragma with "
                "a reason",
                scope=self.scope,
            )
        self.generic_visit(node)


def run(ctx: FileContext):
    if "except" not in ctx.source:
        return None
    _Visitor(ctx).visit(ctx.tree)
    return None


def finalize(states):
    return []
