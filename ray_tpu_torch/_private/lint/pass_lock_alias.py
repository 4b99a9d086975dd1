"""TPU204 — cross-file lock aliasing (closes the carried ROADMAP item).

TPU202 sees a lock only where its *name* is visible. A lock passed as
an argument, stowed in an attribute, or parked in a dict is invisible
there — and those are precisely the locks that end up acquired in an
order nobody audited::

    # a.py                          # b.py
    _table_lock = Lock()            class Flusher:
    f = Flusher(_table_lock)            def __init__(self, lk):
    def update():                           self._lk = lk
        with _table_lock:               def flush(self):
            f.flush()                       with self._lk: ...

TPU204 tracks three alias channels and feeds the resulting edges into
the same order graph TPU202 cycles over:

- **arguments**: ``with param:`` inside a function is a parameterized
  acquisition, instantiated with the concrete lock at every call site
  (transitively — a param forwarded to another function keeps
  resolving).
- **attributes**: ``self._lk = lk`` unifies ``Class._lk`` with
  whatever each constructor call passes.
- **containers**: ``self._locks[k] = Lock()`` / ``with
  self._locks[k]:`` with a VARIABLE key collapse to one summary node
  per container (``Class._locks[]``); a STRING-LITERAL key gets its
  own node (``Class._locks["a"]``), so the ordering between
  ``self._locks["a"]`` and ``self._locks["b"]`` is visible — the
  per-container-summary caveat, closed.

Cycles whose every edge was already visible to TPU202 stay TPU202;
only cycles that NEED an aliased edge report here, so one deadlock
never fires twice. Heavily polymorphic bindings (a param fed more than
``_MAX_BINDINGS`` distinct locks) are dropped rather than unioned —
merging unrelated locks would invent cycles."""

from __future__ import annotations

import ast
import dataclasses

from ray_tpu_torch._private.lint import dataflow
from ray_tpu_torch._private.lint.core import (
    RULES,
    FileContext,
    ScopeVisitor,
    Violation,
    dotted_name,
)
from ray_tpu_torch._private.lint.pass_locks import _sccs

_LOCKISH = ("lock", "mutex")
_LOCK_FACTORIES = frozenset({
    "Lock", "RLock", "InstrumentedLock", "maybe_lock", "maybe_rlock",
    "allocate_lock",
})
_MAX_BINDINGS = 3


def _is_lockish(name: str) -> bool:
    last = name.split(".")[-1].lower()
    return any(t in last for t in _LOCKISH)


def _is_container_node(canon: str) -> bool:
    """Summary (``C._locks[]``) or per-key (``C._locks["a"]``) node."""
    return canon.endswith("]")


def _container_summary(canon: str) -> str | None:
    """``C._locks["a"]`` → ``C._locks[]``; None for non-key nodes."""
    if canon.endswith("]") and not canon.endswith("[]"):
        return canon[: canon.index("[")] + "[]"
    return None


def _subscript_node(base: str, sl: ast.AST) -> str:
    """Container node name for ``base[sl]``: per-constant-key when the
    subscript is a string literal, the per-container summary otherwise
    (a variable key could be ANY key — one node, soundly merged)."""
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
        return f'{base}["{sl.value}"]'
    return base + "[]"


@dataclasses.dataclass
class _Loc:
    path: str
    line: int
    snippet: str
    allowed: bool


@dataclasses.dataclass
class AliasState:
    mi: dataflow.ModuleIndex = None
    # canonical names assigned a Lock()/RLock() factory result
    lock_defs: set = dataclasses.field(default_factory=set)
    # (canonical_name, Item) — attr/container/name aliases
    aliases: list = dataclasses.field(default_factory=list)
    # fn_qual -> set[Item] acquired directly (with-blocks)
    direct_acq: dict = dataclasses.field(default_factory=dict)
    # (held Item, acquired Item, _Loc) nested acquisitions
    edges: list = dataclasses.field(default_factory=list)
    # (fn, callee, binding, attr_call, held Items, _Loc) calls w/ locks held
    held_calls: list = dataclasses.field(default_factory=list)
    # (fn, callee, binding, attr_call) every call passing a lock item
    call_bindings: list = dataclasses.field(default_factory=list)


class _Visitor(ScopeVisitor):
    """Collects acquisitions/aliases/bindings; items are
    ``("L", canonical)`` for concrete names and ``("P", fn, i)`` for
    the i-th formal parameter of ``fn``."""

    def __init__(self, ctx: FileContext, mi: dataflow.ModuleIndex):
        super().__init__(ctx)
        self.mi = mi
        self.state = AliasState(mi=mi)
        self._held: list = []
        self._params: list[dict[str, int]] = []

    # ---------------------------------------------------------- naming
    def _qualify(self, name: str) -> str:
        return self.mi.qualify(name, self._klass())

    def _klass(self):
        return self._class[-1] if self._class else None

    def _fn_qual(self) -> str:
        klass = self._klass()
        if klass and self._func:
            return f"{klass}.{self._func[-1]}"
        if self._func:
            return f"{self.mi.module}.{self._func[-1]}"
        return f"{self.mi.module}.<module>"

    # --------------------------------------------------------- items
    def _item(self, expr) -> tuple | None:
        if isinstance(expr, ast.Name):
            if self._params and expr.id in self._params[-1]:
                return ("P", self._fn_qual(), self._params[-1][expr.id])
            return ("L", self._qualify(expr.id))
        name = dotted_name(expr)
        if name:
            return ("L", self._qualify(name))
        if isinstance(expr, ast.Subscript):
            base = dotted_name(expr.value)
            if base:
                return ("L", _subscript_node(
                    self._qualify(base), expr.slice))
        return None

    def _loc(self, node) -> _Loc:
        line = getattr(node, "lineno", 1)
        return _Loc(
            path=self.ctx.path,
            line=line,
            snippet=self.ctx.snippet(line),
            allowed=self.ctx.allowed(line, "TPU204"),
        )

    # ------------------------------------------------------- scaffolding
    def _visit_func(self, node):
        params = {a.arg: i for i, a in enumerate(
            node.args.posonlyargs + node.args.args)}
        for j, a in enumerate(node.args.kwonlyargs):
            params.setdefault(a.arg, len(node.args.posonlyargs)
                              + len(node.args.args) + j)
        self._params.append(params)
        held, self._held = self._held, []
        super()._visit_func(node)
        self._held = held
        self._params.pop()

    def visit_Lambda(self, node):
        held, self._held = self._held, []
        self.generic_visit(node)
        self._held = held

    # ------------------------------------------------------ acquisitions
    def _with_item(self, expr) -> tuple | None:
        if isinstance(expr, ast.Call):
            # factory style: self._pool_lock(name) — lockish calls only
            name = dotted_name(expr.func)
            if name and _is_lockish(name):
                return ("L", self._qualify(name))
            return None
        return self._item(expr)

    def _enter_with(self, node):
        fn = self._fn_qual()
        acquired = []
        for item in node.items:
            it = self._with_item(item.context_expr)
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            if it is None:
                continue
            self.state.direct_acq.setdefault(fn, set()).add(it)
            loc = self._loc(node)
            for held in self._held:
                if held != it:
                    self.state.edges.append((held, it, loc))
            self._held.append(it)
            acquired.append(it)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    def visit_With(self, node):
        self._enter_with(node)

    def visit_AsyncWith(self, node):
        self._enter_with(node)

    # ------------------------------------------------------ assignments
    def _maybe_alias(self, target, value):
        # target canonical
        tgt = None
        name = dotted_name(target)
        if name:
            tgt = self._qualify(name)
        elif isinstance(target, ast.Subscript):
            base = dotted_name(target.value)
            if base:
                tgt = _subscript_node(self._qualify(base), target.slice)
        if tgt is None:
            return
        if isinstance(value, ast.Call):
            fname = dotted_name(value.func)
            if fname and fname.split(".")[-1] in _LOCK_FACTORIES:
                self.state.lock_defs.add(tgt)
            return
        it = self._item(value)
        if it is not None:
            self.state.aliases.append((tgt, it))

    def visit_Assign(self, node: ast.Assign):
        for target in node.targets:
            self._maybe_alias(target, node.value)
        self.generic_visit(node)

    # ----------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call):
        callee = self.mi.resolve_call(node, self._klass())
        if callee is not None:
            binding = {}
            for pos, arg in enumerate(node.args):
                it = self._item(arg)
                if it is not None:
                    binding[pos] = it
            kwbinding = {}
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                it = self._item(kw.value)
                if it is not None:
                    kwbinding[kw.arg] = it
            attr_call = isinstance(node.func, ast.Attribute)
            if binding or kwbinding:
                self.state.call_bindings.append(
                    (self._fn_qual(), callee, binding, kwbinding,
                     attr_call))
            if self._held:
                self.state.held_calls.append(
                    (self._fn_qual(), callee, binding, kwbinding,
                     attr_call, list(self._held), self._loc(node)))
        self.generic_visit(node)


def run(ctx: FileContext):
    # No textual prefilter here: the whole point of the alias pass is
    # locks living under names that DON'T look like locks.
    mi = dataflow.index(ctx)
    v = _Visitor(ctx, mi)
    v.visit(ctx.tree)
    return v.state


# --------------------------------------------------------------------------
# Linking
# --------------------------------------------------------------------------


class _UnionFind:
    def __init__(self):
        self.parent: dict[str, str] = {}
        self.size: dict[str, int] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb
            self.size[rb] = self.size.get(rb, 1) + self.size.get(ra, 1)

    def merged(self, x: str) -> bool:
        return self.size.get(self.find(x), 1) > 1


def _resolve_binding(callee_info, binding, kwbinding, attr_call, is_ctor):
    """Map arg positions / kw names onto the callee's PARAM indexes."""
    if callee_info is None:
        return {}
    params = callee_info.params
    offset = 1 if (params and params[0] in ("self", "cls")
                   and (attr_call or is_ctor)) else 0
    out = {}
    for pos, item in binding.items():
        out[pos + offset] = item
    for kwname, item in kwbinding.items():
        if kwname in params:
            out[params.index(kwname)] = item
    return out


def finalize(states):
    states = [st for st in states if st is not None]
    if not states:
        return []
    program = dataflow.Program([st.mi for st in states])

    # Constructor resolution: a call to `module.C` is `C.__init__`.
    ctor_map = {}
    for qual in program.functions:
        cls, _, meth = qual.partition(".")
        if meth == "__init__":
            ctor_map.setdefault(cls, qual)

    def resolve_callee(callee):
        """(resolved qual, is_ctor) — or (None, False) if unknown."""
        if callee in program.functions:
            return callee, False
        tail = callee.split(".")[-1]
        if tail in ctor_map:
            return ctor_map[tail], True
        return None, False

    # Lock-relevance pre-filter: bindings of config objects and other
    # non-lock values would flood the param lattice — keep only items
    # that can plausibly BE a lock (lockish name, known Lock() def,
    # container node, alias target, or a formal param).
    lock_names_early: set[str] = set()
    alias_targets: set[str] = set()
    for st in states:
        lock_names_early |= st.lock_defs
        for tgt, _ in st.aliases:
            alias_targets.add(tgt)

    def _relevant(item) -> bool:
        if item[0] == "P":
            return True
        c = item[1]
        return (_is_lockish(c) or c in lock_names_early
                or c in alias_targets or _is_container_node(c))

    # ---------------------------------------------------- param values
    # (fn, idx) -> set of "L" canonicals / ("P", fn', idx') refs
    param_values: dict[tuple, set] = {}
    norm_calls = []   # (caller, callee_qual, {param_idx: Item})
    for st in states:
        for (caller, callee, binding, kwbinding, attr_call) \
                in st.call_bindings:
            q, is_ctor = resolve_callee(callee)
            if q is None:
                continue
            b = _resolve_binding(program.functions[q], binding,
                                 kwbinding, attr_call, is_ctor)
            b = {i: it for i, it in b.items() if _relevant(it)}
            if b:
                norm_calls.append((caller, q, b))
                for idx, item in b.items():
                    param_values.setdefault((q, idx), set()).add(item)

    # Fixpoint: a param bound to another fn's param keeps resolving.
    def ground_params(item, seen=None) -> set:
        """Item -> set of concrete 'L' canonicals."""
        if item[0] == "L":
            return {item[1]}
        if seen is None:
            seen = set()
        key = (item[1], item[2])
        if key in seen:
            return set()
        seen.add(key)
        out = set()
        for bound in param_values.get(key, ()):
            out |= ground_params(bound, seen)
            if len(out) > _MAX_BINDINGS:
                return set()   # too polymorphic — dropping beats lying
        return out

    # -------------------------------------------------------- lockhood
    uf = _UnionFind()
    lock_names: set[str] = set()
    for st in states:
        lock_names |= st.lock_defs
    alias_pairs = []
    for st in states:
        for tgt, item in st.aliases:
            alias_pairs.append((tgt, item))
    for tgt, item in alias_pairs:
        grounded = ground_params(item)
        if not (0 < len(grounded) <= _MAX_BINDINGS):
            continue
        # Union only lock-relevant aliases: `self.cfg = cfg` must not
        # stitch arbitrary config names into the lock graph.
        if not (_is_lockish(tgt) or tgt in lock_names
                or any(_is_lockish(g) or g in lock_names
                       for g in grounded)):
            continue
        for g in grounded:
            uf.union(tgt, g)

    lock_reps = set()
    for c in set(uf.parent) | lock_names:
        if _is_lockish(c) or c in lock_names:
            lock_reps.add(uf.find(c))

    # Lockhood flows between a container's summary node and its
    # per-key nodes: `self._m["a"] = Lock()` makes a variable-key
    # acquisition of the same dict (`self._m[k]` → `C._m[]`) a lock,
    # and a summary-level Lock() def covers every literal key.
    per_key_lock_containers = {
        _container_summary(c) for c in lock_names
        if _container_summary(c) is not None
    }

    def is_lock(canon: str) -> bool:
        if (_is_lockish(canon) or canon in lock_names
                or uf.find(canon) in lock_reps):
            return True
        if canon.endswith("[]") and canon in per_key_lock_containers:
            return True
        summ = _container_summary(canon)
        return summ is not None and (summ in lock_names
                                     or _is_lockish(summ))

    # ----------------------------------------------------- acq closure
    acq: dict[str, set] = {}
    for st in states:
        for fn, items in st.direct_acq.items():
            acq.setdefault(fn, set()).update(items)
    changed = True
    guard = 0
    while changed and guard < 50:
        changed = False
        guard += 1
        for caller, callee, binding in norm_calls:
            got = acq.setdefault(caller, set())
            before = len(got)
            for item in acq.get(callee, ()):
                if item[0] == "L":
                    got.add(item)
                elif item[1] == callee and item[2] in binding:
                    got.add(binding[item[2]])
            if len(got) != before:
                changed = True

    # --------------------------------------------------------- edges
    # (rep_a, rep_b) -> (loc, aliased)
    grounded_edges: dict[tuple, tuple] = {}

    def add_edge(a_item, b_item, loc, via_alias):
        for a in ground_params(a_item):
            for b in ground_params(b_item):
                if a == b or not (is_lock(a) and is_lock(b)):
                    continue
                aliased = (
                    via_alias
                    or a_item[0] == "P" or b_item[0] == "P"
                    or _is_container_node(a) or _is_container_node(b)
                    or uf.merged(a) or uf.merged(b)
                    or not _is_lockish(a) or not _is_lockish(b)
                )
                key = (uf.find(a), uf.find(b))
                if key[0] == key[1]:
                    continue
                prev = grounded_edges.get(key)
                if prev is None or (aliased and not prev[1]):
                    grounded_edges[key] = (loc, aliased)

    for st in states:
        for held, it, loc in st.edges:
            add_edge(held, it, loc, False)
        for (caller, callee, binding, kwbinding, attr_call, held,
             loc) in st.held_calls:
            q, is_ctor = resolve_callee(callee)
            if q is None:
                continue
            b = _resolve_binding(program.functions[q], binding,
                                 kwbinding, attr_call, is_ctor)
            for item in acq.get(q, ()):
                resolved = item
                via_param = False
                if item[0] == "P":
                    if item[1] == q and item[2] in b:
                        resolved = b[item[2]]
                        via_param = True
                    else:
                        continue
                # A callee acquiring a NAMED lock is visible to TPU202's
                # own call closure — only param-instantiated locks make
                # the edge "aliased".
                for h in held:
                    add_edge(h, resolved, loc, via_param)

    # ------------------------------------------------------------ SCC
    graph: dict[str, set[str]] = {}
    for a, b in grounded_edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    violations = []
    for comp in _sccs(graph):
        comp_set = set(comp)
        comp_edges = [(k, grounded_edges[k]) for k in grounded_edges
                      if k[0] in comp_set and k[1] in comp_set]
        if not any(aliased for _, (_, aliased) in comp_edges):
            continue   # fully name-visible: TPU202's report, not ours
        comp_edges.sort(key=lambda kv: (kv[1][0].path, kv[1][0].line))
        anchor = next(
            (loc for _, (loc, aliased) in comp_edges
             if aliased and not loc.allowed), None)
        if anchor is None:
            continue
        cycle = " -> ".join(comp + [comp[0]])
        violations.append(Violation(
            rule="TPU204",
            name=RULES["TPU204"],
            path=anchor.path,
            line=anchor.line,
            col=0,
            message=(
                f"lock-order cycle {cycle} through an ALIASED lock "
                "(passed as argument / stored in attribute or "
                "container): two threads taking these locks in "
                "opposite orders deadlock, and no single file shows "
                "the inversion — pick one global order"
            ),
            scope="|".join(comp),
            snippet=anchor.snippet,
        ))
    return violations
