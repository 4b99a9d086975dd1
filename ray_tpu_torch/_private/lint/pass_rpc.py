"""TPU501 — rpc-reentrancy.

Head/node RPC handlers follow the ``_on_<method>`` naming convention
(dispatched by ``_handle``). A handler that calls
``<peer>.call("<method>")`` where ``<method>`` is handled by the SAME
module is calling back into its own process: under load (or when the
connection pool serializes on one peer) the inner call queues behind
the very handler issuing it — a self-deadlock that only manifests as
an RPC deadline. Restructure to call the local method directly
(``self._on_x(...)`` / shared helper) instead of going over the wire.
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, iter_tree


def _handler_names(tree: ast.Module) -> set[str]:
    out = set()
    for node in iter_tree(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith("_on_"):
                out.add(node.name[len("_on_"):])
    return out


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext):
        super().__init__(ctx)
        self._handlers = _handler_names(ctx.tree)

    def visit_Call(self, node: ast.Call):
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "call"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and self._func
            and any(f.startswith("_on_") for f in self._func)
        ):
            method = node.args[0].value
            if method in self._handlers:
                self.ctx.report(
                    "TPU501", node,
                    f"RPC handler issues `call(\"{method}\")` — a "
                    "method handled by THIS module: the round-trip "
                    "back into our own server can queue behind this "
                    "very handler (self-deadlock); call the local "
                    f"method `_on_{method}` directly",
                    scope=self.scope,
                )
        self.generic_visit(node)


def run(ctx: FileContext):
    # Reentrancy needs BOTH a local `_on_<method>` handler and a
    # `.call(` site in the same file.
    if "_on_" not in ctx.source or ".call(" not in ctx.source:
        return None
    _Visitor(ctx).visit(ctx.tree)
    return None


def finalize(states):
    return []
