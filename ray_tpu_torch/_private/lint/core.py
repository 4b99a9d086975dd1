"""tpulint core: file walking, pragma parsing, violation model.

The passes are deliberately heuristic — name-based lock detection,
token-based rank detection — tuned against THIS codebase's idioms
(``self._lock``, ``col.allreduce``, ``_on_<method>`` RPC handlers).
Since the v2 engine (``dataflow.py``) the flow-sensitive passes
(TPU103/104/203/204/404) add interprocedural reach — call-graph
closure, argument/attribute/container lock aliasing, and a
branch/loop/early-return-aware abstract interpreter — but names are
still unified syntactically; precision ultimately comes from the
pragma escape hatch, and runtime truth from ``sanitize.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

PRAGMA_RE = re.compile(
    r"#\s*tpulint:\s*allow\(\s*([A-Za-z0-9_,\s-]+?)\s+reason=[^)]+\)"
)

#: Rule id → pragma name. A pragma may name either form.
RULES = {
    "TPU101": "collective-divergence",
    "TPU102": "collective-divergence",
    "TPU103": "rank-divergence-flow",
    "TPU104": "dropped-handle",
    "TPU201": "blocking-under-lock",
    "TPU202": "lock-order",
    "TPU203": "async-lock",
    "TPU204": "lock-alias",
    "TPU301": "broad-except",
    "TPU401": "metric-in-function",
    "TPU402": "span-leak",
    "TPU403": "unbounded-metric-label",
    "TPU404": "resource-pairing",
    "TPU501": "rpc-reentrancy",
    "TPU601": "host-sync-in-hot-path",
    "TPU701": "rpc-contract-drift",
    "TPU702": "journal-replay-completeness",
    "TPU703": "knob-discipline",
    "TPU704": "pubsub-channel-discipline",
    "TPU705": "metric-schema-drift",
}

# Generated / vendored files nobody hand-edits.
DEFAULT_EXCLUDES = ("_pb2.py", "_pb2_grpc.py")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str       # "TPU301"
    name: str       # "broad-except"
    path: str       # as given to the analyzer (usually repo-relative)
    line: int
    col: int
    message: str
    scope: str = "<module>"   # enclosing Class.function
    snippet: str = ""         # stripped source line

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline: edits above a
        pinned violation must not make it read as new."""
        return "|".join(
            (self.rule, self.path.replace(os.sep, "/"), self.scope,
             self.snippet)
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.name}] {self.message}"
        )


def parse_pragmas(lines: list[str]) -> dict[int, set[str]]:
    """1-based line → set of allowed rule tokens (rule ids or names).

    A pragma without ``reason=`` is intentionally inert: the reason IS
    the review artifact (why this broad except / blocking call is
    deliberate), so an unexplained allow must not suppress anything.
    """
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        if "tpulint" not in text:
            continue
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        tokens = {t.strip() for t in m.group(1).split(",") if t.strip()}
        out[i] = tokens
    return out


def iter_tree(node: ast.AST):
    """``ast.walk`` with the deque/iter_child_nodes generator overhead
    stripped (~2x faster; same node set, order unspecified). The full
    sweep walks every tree ~10 times across twenty passes — this is the
    analyzer's hottest primitive."""
    stack = [node]
    pop = stack.pop
    push = stack.append
    isinst = isinstance
    _AST = ast.AST
    while stack:
        n = pop()
        yield n
        for f in n._fields:
            v = getattr(n, f, None)
            if type(v) is list:
                for c in v:
                    if isinst(c, _AST):
                        push(c)
            elif isinst(v, _AST):
                push(v)


def iter_children(node: ast.AST):
    """``ast.iter_child_nodes`` without the chained iter_fields
    generator — same children, ~2x faster."""
    isinst = isinstance
    _AST = ast.AST
    for f in node._fields:
        v = getattr(node, f, None)
        if type(v) is list:
            for c in v:
                if isinst(c, _AST):
                    yield c
        elif isinst(v, _AST):
            yield v


class FileContext:
    """One parsed file plus everything a pass needs to report on it."""

    def __init__(self, path: str, source: str, display_path: str | None = None,
                 strict: bool = False):
        self.path = display_path or path
        self.real_path = path
        self.strict = strict
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.pragmas = parse_pragmas(self.lines)
        self.module = os.path.basename(path)[:-3] if path.endswith(
            ".py") else os.path.basename(path)
        self.violations: list[Violation] = []
        self._nodes: list[ast.AST] | None = None

    @property
    def nodes(self) -> list[ast.AST]:
        """Every node in the tree, walked once and cached — passes that
        scan the whole module iterate this instead of re-walking."""
        if self._nodes is None:
            self._nodes = list(iter_tree(self.tree))
        return self._nodes

    def allowed(self, line: int, rule: str) -> bool:
        """Pragma on the statement line or the line directly above."""
        tokens = self.pragmas.get(line, set()) | self.pragmas.get(
            line - 1, set())
        return bool(tokens & {rule, RULES.get(rule, ""), "all"})

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def report(self, rule: str, node: ast.AST, message: str,
               scope: str = "<module>") -> None:
        line = getattr(node, "lineno", 1)
        if self.allowed(line, rule):
            return
        self.violations.append(Violation(
            rule=rule,
            name=RULES[rule],
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            scope=scope,
            snippet=self.snippet(line),
        ))


def dotted_name(node: ast.AST) -> str:
    """'self._lock', 'time.sleep', 'col.allreduce' — '' if not a pure
    Name/Attribute chain (calls, subscripts break the chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class ScopeVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing Class.function qualname.

    ``visit``/``generic_visit`` are reimplemented without the stdlib's
    per-node string concat + iter_fields generators: every pass visitor
    in the package subclasses this, and the dispatch overhead was the
    second-hottest line in the full sweep after ``ast.walk``.
    """

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self._class: list[str] = []
        self._func: list[str] = []
        self._vcache: dict = {}

    def visit(self, node):
        cls = node.__class__
        method = self._vcache.get(cls, False)
        if method is False:
            method = getattr(self, "visit_" + cls.__name__, None)
            self._vcache[cls] = method
        if method is not None:
            return method(node)
        return self.generic_visit(node)

    def generic_visit(self, node):
        visit = self.visit
        isinst = isinstance
        _AST = ast.AST
        for f in node._fields:
            v = getattr(node, f, None)
            if type(v) is list:
                for c in v:
                    if isinst(c, _AST):
                        visit(c)
            elif isinst(v, _AST):
                visit(v)

    def visit_Constant(self, node):
        """Constants are leaves; shadow the stdlib's per-node
        deprecation shim (it's ~5% of a full sweep by itself)."""

    @property
    def scope(self) -> str:
        parts = self._class[-1:] + self._func[-1:]
        return ".".join(parts) if parts else "<module>"

    @property
    def in_function(self) -> bool:
        return bool(self._func)

    def visit_ClassDef(self, node: ast.ClassDef):
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def _visit_func(self, node):
        self._func.append(node.name)
        self.enter_function(node)
        self.generic_visit(node)
        self.exit_function(node)
        self._func.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node)

    def enter_function(self, node) -> None:  # hooks for passes
        pass

    def exit_function(self, node) -> None:
        pass


def iter_python_files(paths, excludes: tuple[str, ...] = DEFAULT_EXCLUDES):
    """Yield .py files under the given files/directories, skipping
    __pycache__ and excluded suffixes, in sorted order."""
    seen = set()
    for root in paths:
        if os.path.isfile(root):
            if root not in seen:
                seen.add(root)
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                if any(fn.endswith(suf) for suf in excludes):
                    continue
                p = os.path.join(dirpath, fn)
                if p not in seen:
                    seen.add(p)
                    yield p


def _passes():
    # Imported lazily so `import ray_tpu_torch._private.lint.core` works while
    # a pass module is mid-edit (and to keep import cost off the
    # non-lint path).
    from ray_tpu_torch._private.lint import (
        pass_async_locks,
        pass_collective,
        pass_exceptions,
        pass_handles,
        pass_host_sync,
        pass_journal,
        pass_knobs,
        pass_lock_alias,
        pass_locks,
        pass_metric_schema,
        pass_metrics,
        pass_pairing,
        pass_pubsub,
        pass_rank_flow,
        pass_rpc,
        pass_rpc_contract,
    )
    return [pass_collective, pass_exceptions, pass_locks, pass_metrics,
            pass_rpc, pass_rank_flow, pass_handles, pass_async_locks,
            pass_lock_alias, pass_pairing, pass_host_sync,
            pass_rpc_contract, pass_journal,
            pass_knobs, pass_pubsub, pass_metric_schema]


def analyze_source(source: str, path: str = "<string>",
                   strict: bool = False) -> list[Violation]:
    """Run every pass over one in-memory module (fixture tests)."""
    ctx = FileContext(path, source, strict=strict)
    for mod in _passes():
        state = mod.run(ctx)
        if state is not None:
            ctx.violations.extend(mod.finalize([state]))
    ctx.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return ctx.violations


def analyze_file(path: str, display_path: str | None = None,
                 strict: bool = False) -> list[Violation]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    ctx = FileContext(path, source, display_path=display_path, strict=strict)
    for mod in _passes():
        state = mod.run(ctx)
        if state is not None:
            ctx.violations.extend(mod.finalize([state]))
    ctx.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return ctx.violations


def analyze_paths(paths, relative_to: str | None = None,
                  excludes: tuple[str, ...] = DEFAULT_EXCLUDES,
                  strict: bool = False):
    """Analyze every .py file under ``paths``.

    Returns (violations, errors) where errors is a list of
    (path, message) for unparseable files — reported, never fatal:
    one syntax-broken WIP file must not hide the report for the rest
    of the tree.
    """
    contexts: list[FileContext] = []
    errors: list[tuple[str, str]] = []
    for path in iter_python_files(paths, excludes=excludes):
        display = path
        if relative_to:
            display = os.path.relpath(path, relative_to)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            contexts.append(FileContext(path, source, display_path=display,
                                        strict=strict))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append((display, f"{type(e).__name__}: {e}"))

    violations: list[Violation] = []
    for mod in _passes():
        states = []
        for ctx in contexts:
            state = mod.run(ctx)
            if state is not None:
                states.append(state)
        violations.extend(mod.finalize(states))
    for ctx in contexts:
        violations.extend(ctx.violations)
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations, errors
