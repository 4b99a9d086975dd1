"""TPU704 — pubsub channel discipline.

A pubsub channel is a bare string agreed on by publisher and
subscriber; a typo on either side is a subscription that silently
receives nothing, forever. And the head coalesces
publishes per event-loop tick: any channel can deliver a
``{"channel", "batch": [...]}`` frame instead of ``{"channel",
"msg"}``, so a raw ``on_push=`` handler that only unpacks ``msg``
silently drops every message that arrived coalesced — the exact shape
the tqdm_ray/core_worker handlers were fixed to unpack. Two checks:

- channel consistency: every constant channel subscribed to
  (``.call("subscribe", channel="X")`` or ``core.subscribe("X", h)``)
  must have at least one constant publish site (``.publish("X", ...)``
  or ``.call("publish", channel="X", ...)``) in the analyzed program.
  The reverse direction is NOT checked — channels like ``node`` /
  ``actor`` are legitimately subscribed only by tests and dashboards.
- batch-frame safety: a module that subscribes AND installs a raw
  ``on_push=`` handler must unpack batch frames — detected as the
  handler function (resolved module-locally) mentioning the ``batch``
  key anywhere in its body. Subscribers routed through
  ``CoreWorker.subscribe`` are exempt: ``_on_head_push`` unbatches
  centrally before per-channel dispatch.

Dynamic channel strings (variables, f-strings) are out of static
reach and skipped, as is the head's own ``_on_publish`` passthrough.
Reporting is gated on the program containing at least one publish
site (a lone subscriber module has no channel universe to check
against).
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import protocol
from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name, iter_tree


class _State:
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.published: set = set()
        self.subscribed: list[tuple] = []   # (channel, line, scope)
        self.subscribes_any = False         # incl. dynamic channels
        self.on_push: list[tuple] = []      # (handler_name, line, scope)
        self.functions: dict[str, ast.AST] = {}


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext, st: _State):
        super().__init__(ctx)
        self.st = st

    def enter_function(self, node):
        self.st.functions.setdefault(node.name, node)

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        func = node.func
        for kw in node.keywords:
            if kw.arg == "on_push":
                name = dotted_name(kw.value)
                if name:
                    self.st.on_push.append(
                        (name.split(".")[-1], node.lineno, self.scope))
        if not isinstance(func, ast.Attribute):
            return
        if func.attr == "publish" and node.args:
            ch = _const_str(node.args[0])
            if ch:
                self.st.published.add(ch)
        elif func.attr == "subscribe" and node.args:
            ch = _const_str(node.args[0])
            self.st.subscribes_any = True
            if ch:
                self.st.subscribed.append((ch, node.lineno, self.scope))
        elif func.attr == "call" and node.args:
            verb = _const_str(node.args[0])
            if verb not in ("publish", "subscribe"):
                return
            channel = None
            for kw in node.keywords:
                if kw.arg == "channel":
                    channel = _const_str(kw.value)
            if verb == "publish":
                if channel:
                    self.st.published.add(channel)
            else:
                self.st.subscribes_any = True
                if channel:
                    self.st.subscribed.append(
                        (channel, node.lineno, self.scope))


def run(ctx: FileContext):
    if not ("publish" in ctx.source or "subscribe" in ctx.source
            or "on_push" in ctx.source):
        return None
    st = _State(ctx)
    _Visitor(ctx, st).visit(ctx.tree)
    if not (st.published or st.subscribed or st.on_push):
        return None
    return st


def _handles_batch(fn: ast.AST) -> bool:
    for node in iter_tree(fn):
        if isinstance(node, ast.Constant) and node.value == "batch":
            return True
    return False


def finalize(states):
    published: set = set()
    for st in states:
        published |= st.published
    for st in states:
        if published:
            for channel, line, scope in st.subscribed:
                if channel not in published:
                    st.ctx.report(
                        "TPU704", protocol.FakeNode(line),
                        f"subscribed channel {channel!r} is never "
                        "published anywhere in the analyzed program — "
                        "a typo'd channel name receives nothing, "
                        "silently, forever "
                        f"(published channels: {sorted(published)})",
                        scope=scope)
        if not st.subscribes_any:
            continue
        seen: set = set()
        for handler, line, scope in st.on_push:
            if handler in seen:
                continue
            seen.add(handler)
            fn = st.functions.get(handler)
            if fn is None:
                continue  # imported handler: out of module-local reach
            if not _handles_batch(fn):
                st.ctx.report(
                    "TPU704", protocol.FakeNode(fn.lineno),
                    f"push handler {handler!r} never unpacks coalesced "
                    '{"channel", "batch": [...]} frames — the head '
                    "batches publishes per event-loop tick, so this "
                    "subscriber silently drops every message that "
                    "arrives coalesced",
                    scope=scope)
    return []
