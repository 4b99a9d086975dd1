"""TPU701 — RPC contract drift.

The control plane's ~83 ``*.call("method", **kw)`` sites and ~40
``async def _on_<method>(self, conn, ...)`` handlers are bound only by
a string at runtime — and ``rpc.tolerant_kwargs`` silently drops any
kwarg the handler doesn't accept (version-skew tolerance), so a typo'd
method name raises late and a typo'd kwarg never raises at all. This
pass binds every string-method call site to the program-wide handler
table (``lint/protocol.py``) and reports:

- unknown method names (no ``_on_<m>`` handler anywhere in the
  analyzed program);
- missing required params (required by EVERY handler of that name);
- unknown kwargs (accepted by NO handler of that name);
- positional payload args (``Connection.call(method, timeout=None,
  **kw)`` makes a second positional arg silently become ``timeout``).

``timeout``/``retry`` are client-transport kwargs, consumed before the
frame is written — always exempt. A call site that splats ``**kw``
can't be checked (the kwargs-dict caveat in the ROADMAP); a dynamic
method name (f-string / variable — the ``col_op:<group>`` extension
idiom) is skipped by default and reported as unresolvable only under
``--strict``, where the runtime contract sanitizer takes over.

Reporting is gated on the program defining at least one handler: a
lone caller module analyzed by itself has no contract to check against
(``--changed`` keeps the gate sound by expanding import neighbors).
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import protocol
from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name

#: Receivers whose ``.call`` is not an RPC (stdlib / test doubles).
_NON_RPC_RECEIVERS = ("subprocess", "mock")


class _CallSite:
    __slots__ = ("ctx", "line", "method", "kwargs", "splat",
                 "extra_pos", "scope", "dynamic")

    def __init__(self, ctx, line, method, kwargs, splat, extra_pos,
                 scope, dynamic):
        self.ctx = ctx
        self.line = line
        self.method = method          # str, or None when dynamic
        self.kwargs = kwargs          # payload kwarg names (transport excluded)
        self.splat = splat            # call had **kw
        self.extra_pos = extra_pos    # positional args beyond the method name
        self.scope = scope
        self.dynamic = dynamic


class _State:
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.handlers: list = []
        self.sites: list[_CallSite] = []


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext, st: _State):
        super().__init__(ctx)
        self.st = st

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr == "call"):
            return
        recv = dotted_name(func.value)
        base = recv.split(".")[0] if recv else ""
        if base in _NON_RPC_RECEIVERS or not node.args:
            return
        head = node.args[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            method, dynamic = head.value, False
        elif isinstance(head, (ast.JoinedStr, ast.Name, ast.Attribute)):
            method, dynamic = None, True
        else:
            return  # not a method-name shape (e.g. subprocess argv list)
        kwargs = set()
        splat = False
        for kw in node.keywords:
            if kw.arg is None:
                splat = True
            elif kw.arg not in protocol.TRANSPORT_KWARGS:
                kwargs.add(kw.arg)
        self.st.sites.append(_CallSite(
            self.ctx, node.lineno, method, kwargs, splat,
            len(node.args) - 1, self.scope, dynamic))


def run(ctx: FileContext):
    has_handlers = "_on_" in ctx.source
    has_calls = ".call(" in ctx.source
    if not has_handlers and not has_calls:
        return None
    st = _State(ctx)
    if has_handlers:
        st.handlers = protocol.handler_signatures(ctx.tree, path=ctx.path)
    if has_calls:
        _Visitor(ctx, st).visit(ctx.tree)
    if not st.handlers and not st.sites:
        return None
    return st


def finalize(states):
    merged = protocol.merge_signatures(
        h for st in states for h in st.handlers)
    if not merged:
        return []
    for st in states:
        for site in st.sites:
            node = protocol.FakeNode(site.line)
            if site.dynamic:
                if getattr(site.ctx, "strict", False):
                    site.ctx.report(
                        "TPU701", node,
                        "dynamic RPC method name — contract unresolvable "
                        "statically (the runtime contract sanitizer under "
                        "RAY_TPU_SANITIZE=1 covers this site)",
                        scope=site.scope)
                continue
            if site.extra_pos:
                site.ctx.report(
                    "TPU701", node,
                    f"RPC payload for {site.method!r} passed positionally: "
                    "Connection.call(method, timeout=None, **kw) makes the "
                    "second positional arg the TIMEOUT — payload must be "
                    "keyword args",
                    scope=site.scope)
                # The stray positional is almost certainly the payload:
                # kwarg-level diagnostics would just restate the bug.
                continue
            sig = merged.get(site.method)
            if sig is None:
                site.ctx.report(
                    "TPU701", node,
                    f"RPC method {site.method!r} has no _on_{site.method} "
                    "handler in the analyzed program — the call raises "
                    "'unknown method' at runtime",
                    scope=site.scope)
                continue
            if site.splat:
                continue  # **kw splat: contract unchecked (ROADMAP caveat)
            unknown = site.kwargs - sig.params if not sig.varkw else set()
            for kw in sorted(unknown):
                site.ctx.report(
                    "TPU701", node,
                    f"RPC {site.method!r}: kwarg {kw!r} is not accepted by "
                    "any handler — tolerant_kwargs silently DROPS it at "
                    "the server (handler "
                    f"{sig.cls or '?'}._on_{site.method} accepts "
                    f"{sorted(sig.params) or 'no payload params'})",
                    scope=site.scope)
            missing = sig.required - site.kwargs
            for kw in sorted(missing):
                site.ctx.report(
                    "TPU701", node,
                    f"RPC {site.method!r}: required param {kw!r} is never "
                    "passed — the handler raises TypeError on dispatch",
                    scope=site.scope)
    return []
