"""TPU702 — journal replay completeness.

The head's durability contract is three hand-maintained mirrors:
every ``self._journal_append(table, op, payload)`` site must have (a) a
replay branch in ``_restore_from_journal`` matching that ``(table,
op)`` pair, (b) payload keys that cover every ``payload["k"]`` read
the replay performs, and (c) the replayed state captured by
``_snapshot()`` — otherwise compaction silently drops the table. A
drift in any mirror is invisible until a head restart replays (or
fails to replay) the record: the worst kind of bug, destructive and
only reachable through crash-recovery chaos tests.

Model extracted per module, bound program-wide at finalize (append
sites and the restore function may live in different files):

- append sites: ``*._journal_append("table", "op", {...})`` with
  constant table/op; dict-literal payloads contribute their key set,
  anything else (a variable, ``**`` expansion) opts the site out of
  the key check only.
- replay branches: ``table == "T"`` / ``op == "O"`` comparison chains
  inside any ``_restore_from_journal``, including one-hop delegation
  (``self._ckpt_replay(op, payload)``) and ``fn(**payload)`` splats,
  whose required-parameter sets become required payload keys.
- required keys are plain ``payload["k"]`` subscripts; ``payload.get``
  reads are migration-tolerant by design and not required.
- ``_snapshot()``: the set of ``self.X`` attributes it captures.

No restore function in the analyzed program → no reporting (a lone
module of append sites has no replay contract to check against).
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import protocol
from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name, iter_tree

_MUTATORS = frozenset({
    "pop", "update", "setdefault", "difference_update", "add",
    "append", "clear", "discard", "remove",
})


class _Region:
    __slots__ = ("required", "mutated", "delegates", "splats")

    def __init__(self):
        self.required: set = set()   # payload["k"] subscript reads
        self.mutated: set = set()    # self.X attrs written/mutated
        self.delegates: set = set()  # fn names called as fn(op, payload)
        self.splats: set = set()     # fn names called as fn(**payload)

    def merge(self, other: "_Region"):
        self.required |= other.required
        self.mutated |= other.mutated
        self.delegates |= other.delegates
        self.splats |= other.splats


class _Branch:
    """Replay coverage for one journaled table."""

    __slots__ = ("ops", "catchall", "common")

    def __init__(self):
        self.ops: dict[str, _Region] = {}
        self.catchall: _Region | None = None
        self.common = _Region()


def _test_consts(test: ast.AST) -> tuple[list[str], list[str]]:
    """Constants compared against ``table`` / ``op`` anywhere in a
    branch test (BoolOp conjuncts included)."""
    tables, ops = [], []
    for node in iter_tree(test):
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], ast.Eq)):
            continue
        left, right = node.left, node.comparators[0]
        if isinstance(left, ast.Constant):
            left, right = right, left
        if not (isinstance(left, ast.Name)
                and isinstance(right, ast.Constant)
                and isinstance(right.value, str)):
            continue
        if left.id == "table":
            tables.append(right.value)
        elif left.id == "op":
            ops.append(right.value)
    return tables, ops


def _collect_region(stmts, region: _Region) -> None:
    for s in stmts:
        for node in iter_tree(s):
            if isinstance(node, ast.Subscript):
                if (isinstance(node.value, ast.Name)
                        and node.value.id == "payload"
                        and isinstance(node.slice, ast.Constant)
                        and isinstance(node.ctx, ast.Load)):
                    region.required.add(node.slice.value)
                tgt = dotted_name(node.value)
                if tgt.startswith("self.") and isinstance(
                        node.ctx, (ast.Store, ast.Del)):
                    region.mutated.add(tgt.split(".")[1])
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    name = dotted_name(t)
                    if name.startswith("self."):
                        region.mutated.add(name.split(".")[1])
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute):
                    recv = dotted_name(func.value)
                    if func.attr in _MUTATORS and recv.startswith("self."):
                        region.mutated.add(recv.split(".")[1])
                    arg_names = {a.id for a in node.args
                                 if isinstance(a, ast.Name)}
                    if {"op", "payload"} <= arg_names:
                        region.delegates.add(func.attr)
                    for kw in node.keywords:
                        if (kw.arg is None and isinstance(kw.value, ast.Name)
                                and kw.value.id == "payload"):
                            region.splats.add(func.attr)


def _visit_branches(stmts, table: str | None, op: str | None,
                    model: dict[str, _Branch]) -> None:
    for s in stmts:
        if isinstance(s, ast.If):
            tnames, onames = _test_consts(s.test)
            if table is None and tnames:
                for t in tnames:
                    model.setdefault(t, _Branch())
                    if onames:
                        for o in onames:
                            _visit_branches(
                                s.body, t, o, model)
                    else:
                        _visit_branches(s.body, t, None, model)
                _visit_branches(s.orelse, None, None, model)
                continue
            if table is not None and op is None and onames:
                branch = model.setdefault(table, _Branch())
                for o in onames:
                    region = branch.ops.setdefault(o, _Region())
                    _collect_region(s.body, region)
                if s.orelse:
                    if (len(s.orelse) == 1
                            and isinstance(s.orelse[0], ast.If)):
                        _visit_branches(s.orelse, table, None, model)
                    else:
                        if branch.catchall is None:
                            branch.catchall = _Region()
                        _collect_region(s.orelse, branch.catchall)
                continue
        if table is not None:
            branch = model.setdefault(table, _Branch())
            if op is None:
                _collect_region([s], branch.common)
            else:
                _collect_region([s], branch.ops.setdefault(op, _Region()))
        elif isinstance(s, (ast.For, ast.AsyncFor, ast.While, ast.With,
                            ast.AsyncWith, ast.Try)):
            for body in (getattr(s, "body", []), getattr(s, "orelse", []),
                         getattr(s, "finalbody", [])):
                _visit_branches(body, None, None, model)
            for h in getattr(s, "handlers", []):
                _visit_branches(h.body, None, None, model)


class _AppendSite:
    __slots__ = ("ctx", "line", "table", "op", "keys", "scope")

    def __init__(self, ctx, line, table, op, keys, scope):
        self.ctx = ctx
        self.line = line
        self.table = table
        self.op = op
        self.keys = keys  # set of const payload keys, or None (unchecked)
        self.scope = scope


class _State:
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.appends: list[_AppendSite] = []
        self.restore_model: dict[str, _Branch] = {}
        self.has_restore = False
        self.snapshot_attrs: set = set()
        self.has_snapshot = False
        self.functions: dict[str, ast.AST] = {}


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext, st: _State):
        super().__init__(ctx)
        self.st = st

    def enter_function(self, node):
        self.st.functions.setdefault(node.name, node)
        if node.name == "_restore_from_journal":
            self.st.has_restore = True
            _visit_branches(node.body, None, None, self.st.restore_model)
        elif node.name == "_snapshot":
            self.st.has_snapshot = True
            for sub in iter_tree(node):
                name = dotted_name(sub)
                if name.startswith("self.") and name.count(".") == 1:
                    self.st.snapshot_attrs.add(name.split(".")[1])

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr == "_journal_append") or len(node.args) < 3:
            return
        table_n, op_n, payload = node.args[0], node.args[1], node.args[2]
        if not (isinstance(table_n, ast.Constant)
                and isinstance(op_n, ast.Constant)):
            return  # dynamic table/op: out of static reach
        keys = None
        if isinstance(payload, ast.Dict) and all(
                isinstance(k, ast.Constant) for k in payload.keys):
            keys = {k.value for k in payload.keys}
        self.st.appends.append(_AppendSite(
            self.ctx, node.lineno, table_n.value, op_n.value, keys,
            self.scope))


def run(ctx: FileContext):
    if "_journal_append" not in ctx.source and (
            "_restore_from_journal" not in ctx.source):
        return None
    st = _State(ctx)
    _Visitor(ctx, st).visit(ctx.tree)
    if not st.appends and not st.has_restore:
        return None
    return st


def _required_params(fn: ast.AST) -> set:
    args = fn.args
    pos = [a.arg for a in args.args]
    n_def = len(args.defaults)
    req = set(pos[: len(pos) - n_def]) if n_def else set(pos)
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is None:
            req.add(a.arg)
    req.discard("self")
    return req


def _resolve_delegates(model: dict[str, _Branch],
                       functions: dict[str, ast.AST]) -> None:
    """Fold one-hop delegation (``self._ckpt_replay(op, payload)``)
    into the delegating table's branch: the delegate's own op-dispatch
    becomes the table's op coverage, and ``fn(**payload)`` splats
    inside it contribute the callee's required params as required
    payload keys."""
    for branch in model.values():
        for region in [branch.common, branch.catchall,
                       *branch.ops.values()]:
            if region is None:
                continue
            for name in sorted(region.splats):
                fn = functions.get(name)
                if fn is not None:
                    region.required |= _required_params(fn)
            for name in sorted(region.delegates):
                fn = functions.get(name)
                if fn is None:
                    continue
                sub: dict[str, _Branch] = {}
                _visit_branches(fn.body, "<delegate>", None, sub)
                deleg = sub.get("<delegate>")
                if deleg is None:
                    continue
                for op, op_region in deleg.ops.items():
                    for sname in sorted(op_region.splats):
                        sfn = functions.get(sname)
                        if sfn is not None:
                            op_region.required |= _required_params(sfn)
                    branch.ops.setdefault(op, _Region()).merge(op_region)
                branch.common.merge(deleg.common)
                if deleg.catchall is not None:
                    if branch.catchall is None:
                        branch.catchall = _Region()
                    branch.catchall.merge(deleg.catchall)


def finalize(states):
    model: dict[str, _Branch] = {}
    functions: dict[str, ast.AST] = {}
    snapshot_attrs: set = set()
    has_restore = has_snapshot = False
    for st in states:
        functions.update(st.functions)
        snapshot_attrs |= st.snapshot_attrs
        has_snapshot = has_snapshot or st.has_snapshot
        if st.has_restore:
            has_restore = True
            for t, b in st.restore_model.items():
                if t in model:
                    cur = model[t]
                    cur.common.merge(b.common)
                    for o, r in b.ops.items():
                        cur.ops.setdefault(o, _Region()).merge(r)
                    if b.catchall is not None:
                        if cur.catchall is None:
                            cur.catchall = _Region()
                        cur.catchall.merge(b.catchall)
                else:
                    model[t] = b
    if not has_restore:
        return []
    _resolve_delegates(model, functions)

    snapshot_flagged: set = set()
    for st in states:
        for site in st.appends:
            node = protocol.FakeNode(site.line)
            branch = model.get(site.table)
            if branch is None:
                site.ctx.report(
                    "TPU702", node,
                    f"journal table {site.table!r} has no replay branch "
                    "in _restore_from_journal — records are appended but "
                    "silently dropped on head restart",
                    scope=site.scope)
                continue
            covered = site.op in branch.ops or branch.catchall is not None
            if not covered:
                site.ctx.report(
                    "TPU702", node,
                    f"journal op ({site.table!r}, {site.op!r}) has no "
                    "replay branch (and the table dispatch has no "
                    "catch-all) — the record is skipped on restart",
                    scope=site.scope)
            elif site.keys is not None:
                required = set(branch.common.required)
                if site.op in branch.ops:
                    required |= branch.ops[site.op].required
                elif branch.catchall is not None:
                    required |= branch.catchall.required
                missing = sorted(required - site.keys)
                if missing:
                    site.ctx.report(
                        "TPU702", node,
                        f"journal payload for ({site.table!r}, "
                        f"{site.op!r}) omits key(s) {missing} that the "
                        "replay path reads — restart raises KeyError "
                        "mid-replay",
                        scope=site.scope)
            if has_snapshot and site.table not in snapshot_flagged:
                snapshot_flagged.add(site.table)
                mutated = set(branch.common.mutated)
                for r in branch.ops.values():
                    mutated |= r.mutated
                if branch.catchall is not None:
                    mutated |= branch.catchall.mutated
                if mutated and not (mutated & snapshot_attrs):
                    site.ctx.report(
                        "TPU702", node,
                        f"journal table {site.table!r} replays into "
                        f"{sorted(mutated)} but _snapshot() captures none "
                        "of those attributes — compaction permanently "
                        "drops the table",
                        scope=site.scope)
    return []
