"""TPU705 — metric schema drift across modules.

The metrics registry raises at runtime when the same metric name is
re-registered with a different type or label set — but only when both
registrations happen to execute in the same process. Two modules that
never co-import (a trainer counter and a serve counter sharing a
name) drift forever, and the scrape endpoint exports whichever loaded
first. This pass is the static twin of that runtime raise: it
collects every metric constructor with a constant name
(``Counter/Gauge/Histogram("name", ..., tag_keys=(...))``, the same
detection shape as TPU401) across the whole analyzed program and
reports every site whose type or label set disagrees with the first
registration of that name.

Dynamic names or tag tuples are out of static reach and skipped.
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import protocol
from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor
from ray_tpu_torch._private.lint.pass_metrics import _metric_ctor


class _Site:
    __slots__ = ("ctx", "line", "name", "ctor", "tags", "scope")

    def __init__(self, ctx, line, name, ctor, tags, scope):
        self.ctx = ctx
        self.line = line
        self.name = name
        self.ctor = ctor
        self.tags = tags  # frozenset of label names, or None (dynamic)
        self.scope = scope


def _tag_keys(call: ast.Call):
    """frozenset of constant tag keys; empty when omitted; None when
    the tuple is dynamic."""
    for kw in call.keywords:
        if kw.arg != "tag_keys":
            continue
        if isinstance(kw.value, (ast.Tuple, ast.List)):
            keys = []
            for el in kw.value.elts:
                if (isinstance(el, ast.Constant)
                        and isinstance(el.value, str)):
                    keys.append(el.value)
                else:
                    return None
            return frozenset(keys)
        return None
    return frozenset()


class _State:
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.sites: list[_Site] = []


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext, st: _State):
        super().__init__(ctx)
        self.st = st

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        ctor = _metric_ctor(node)
        if ctor is None or not node.args:
            return
        name = node.args[0]
        if not (isinstance(name, ast.Constant)
                and isinstance(name.value, str)):
            return
        self.st.sites.append(_Site(
            self.ctx, node.lineno, name.value, ctor, _tag_keys(node),
            self.scope))


def run(ctx: FileContext):
    if not any(c in ctx.source for c in ("Counter", "Gauge", "Histogram")):
        return None
    st = _State(ctx)
    _Visitor(ctx, st).visit(ctx.tree)
    if not st.sites:
        return None
    return st


def finalize(states):
    first: dict[str, _Site] = {}
    ordered = [s for st in states for s in st.sites]
    for site in ordered:
        ref = first.setdefault(site.name, site)
        if ref is site:
            continue
        where = f"{ref.ctx.path}:{ref.line}"
        if site.ctor != ref.ctor:
            site.ctx.report(
                "TPU705", protocol.FakeNode(site.line),
                f"metric {site.name!r} registered as {site.ctor} here but "
                f"as {ref.ctor} at {where} — the registry raises if both "
                "modules ever co-import, and exports whichever loaded "
                "first otherwise",
                scope=site.scope)
        elif (site.tags is not None and ref.tags is not None
                and site.tags != ref.tags):
            site.ctx.report(
                "TPU705", protocol.FakeNode(site.line),
                f"metric {site.name!r} registered with labels "
                f"{sorted(site.tags)} here but {sorted(ref.tags)} at "
                f"{where} — series from the two sites are "
                "unjoinable and the runtime registry raises on "
                "co-import",
                scope=site.scope)
    return []
