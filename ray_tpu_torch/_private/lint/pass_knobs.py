"""TPU703 — config knob discipline.

``config.get`` raises ``KeyError`` for an unknown name — but only when
the call actually executes, so a typo'd knob on a cold path (an error
branch, a chaos hook) survives review and detonates in production.
The inverse rot is quieter still: a knob declared in ``CONFIG_DEFS``
whose last reader was refactored away keeps its env var, README row
and test surface alive forever. Three checks:

- ``config.get("X")`` (and calls through one-hop wrappers that forward
  a parameter to ``config.get``, the ``dag/context._cfg`` idiom) must
  name a declared knob;
- raw ``os.environ`` reads of ``RAY_TPU_*`` outside ``config.py`` /
  ``test_utils.py`` bypass the override/env/default resolution order
  and are flagged (bootstrap/debugger reads carry reasoned pragmas);
- declared-but-never-read knobs report as dead at their definition
  line. "Read" is deliberately loose — ANY string mention of the knob
  name outside ``config.py`` counts — so wrapper indirection and
  docs-driven lookups don't false-positive; a knob nobody even names
  is definitively dead.

Doc-drift sub-check: when the analyzed program contains the real
``config.py``, README knob mentions (``RAY_TPU_<NAME>``) must resolve
to a declared knob or an env var the code actually touches — a renamed
knob whose README row survived reports against the README line. The
repository's README documents the JAX package and the port side by
side: where it has the port's section (``PORT_SECTION`` up to the next
``## `` heading) only that section is checked, since the rest names the
JAX package's knobs.

Gates: unknown-key and dead-knob checks need ``CONFIG_DEFS`` in the
analyzed program; the dead check additionally needs at least one
resolved ``config.get`` site (a program with no readers loaded — e.g.
``config.py`` analyzed alone — proves nothing about deadness).
"""

from __future__ import annotations

import ast
import os
import re

from ray_tpu_torch._private.lint import protocol
from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name, iter_tree

_KNOB_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")
# A quoted, fully-uppercase string literal — the textual twin of the
# old "uppercase string constant" AST walk, cheap enough to run on
# every gated file. Comments match too; that only makes the dead-knob
# rule looser, which is its design direction.
_MENTION_RE = re.compile(r"""["']([A-Z][A-Z0-9_]*)["']""")
_ENV_RE = re.compile(r"RAY_TPU_([A-Z][A-Z0-9_]*)")
_EXEMPT_FILES = ("config.py", "test_utils.py")
#: The README heading of the port's own section.
PORT_SECTION = "## PyTorch + CUDA port"


class _State:
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.defs: dict[str, int] = {}      # knob -> def line
        self.defs_is_config = False
        self.defs_real_path = ""
        self.gets: list[tuple] = []         # (key, line, scope)
        self.mentions: set = set()          # uppercase string consts
        self.env_names: set = set()         # RAY_TPU_* touched anywhere


def _collect_defs(tree: ast.Module) -> dict[str, int]:
    defs: dict[str, int] = {}
    for node in iter_tree(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = node.value
            if not isinstance(value, ast.Dict):
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "CONFIG_DEFS":
                    for k in value.keys:
                        if (isinstance(k, ast.Constant)
                                and isinstance(k.value, str)):
                            defs[k.value] = k.lineno
    return defs


def _wrapper_names(tree: ast.Module) -> set:
    """Local functions that forward a parameter to ``config.get``."""
    out: set = set()
    for node in iter_tree(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in node.args.args} | {
            a.arg for a in node.args.kwonlyargs}
        for sub in iter_tree(node):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "get"
                    and dotted_name(sub.func.value) == "config"
                    and len(sub.args) == 1
                    and isinstance(sub.args[0], ast.Name)
                    and sub.args[0].id in params):
                out.add(node.name)
                break
    return out


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext, st: _State, wrappers: set,
                 exempt_env: bool):
        super().__init__(ctx)
        self.st = st
        self.wrappers = wrappers
        self.exempt_env = exempt_env

    def _env_string(self, node: ast.AST) -> str | None:
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("RAY_TPU_")):
            return node.value
        return None

    def visit_Subscript(self, node: ast.Subscript):
        self.generic_visit(node)
        recv = dotted_name(node.value)
        if recv in ("os.environ", "environ"):
            env = self._env_string(node.slice)
            if env and isinstance(node.ctx, ast.Load):
                self._report_env(node, env)

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        func = node.func
        if isinstance(func, ast.Name) and func.id in self.wrappers:
            if (len(node.args) == 1 and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _KNOB_RE.match(node.args[0].value)):
                self.st.gets.append(
                    (node.args[0].value, node.lineno, self.scope))
            return
        if not isinstance(func, ast.Attribute):
            return
        recv = dotted_name(func.value)
        if func.attr == "get" and recv == "config":
            if (len(node.args) == 1 and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _KNOB_RE.match(node.args[0].value)):
                self.st.gets.append(
                    (node.args[0].value, node.lineno, self.scope))
            return
        if recv in ("os.environ", "environ") and func.attr in (
                "get", "setdefault") and node.args:
            env = self._env_string(node.args[0])
            if env and func.attr == "get":
                self._report_env(node, env)
        elif recv == "os" and func.attr == "getenv" and node.args:
            env = self._env_string(node.args[0])
            if env:
                self._report_env(node, env)

    def _report_env(self, node: ast.AST, env: str) -> None:
        if self.exempt_env:
            return
        self.ctx.report(
            "TPU703", node,
            f"raw environ read of {env!r} bypasses the config registry "
            "(override -> env -> default resolution and type coercion); "
            "declare a knob in CONFIG_DEFS and use config.get()",
            scope=self.scope)


def run(ctx: FileContext):
    src = ctx.source
    interesting = ("config" in src or "RAY_TPU_" in src
                   or "CONFIG_DEFS" in src)
    if not interesting:
        return None
    st = _State(ctx)
    # Mentions and env-var names come from a regex sweep — the AST walk
    # is reserved for files that can actually contain get/env sites.
    st.mentions = {m.group(1) for m in _MENTION_RE.finditer(src)}
    st.env_names = {m.group(1) for m in _ENV_RE.finditer(src)}
    if "CONFIG_DEFS" in src:
        st.defs = _collect_defs(ctx.tree)
    if st.defs:
        st.defs_is_config = os.path.basename(
            getattr(ctx, "real_path", ctx.path)) == "config.py"
        st.defs_real_path = getattr(ctx, "real_path", ctx.path)
    has_env_read = (("environ" in src or "getenv" in src)
                    and "RAY_TPU_" in src)
    if "config.get" in src or has_env_read:
        # A one-hop wrapper's body textually contains `config.get`.
        wrappers = _wrapper_names(ctx.tree) if "config.get" in src else set()
        exempt_env = os.path.basename(
            getattr(ctx, "real_path", ctx.path)) in _EXEMPT_FILES
        _Visitor(ctx, st, wrappers, exempt_env).visit(ctx.tree)
    return st


def _find_readme(start: str) -> str | None:
    probe = os.path.dirname(os.path.abspath(start))
    for _ in range(4):
        cand = os.path.join(probe, "README.md")
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    return None


def _readme_region(lines: list[str]) -> tuple[int, int]:
    """0-based [start, end) of the lines to check: the port's section
    where the README has one, else the whole file."""
    start = next((i for i, line in enumerate(lines)
                  if line.startswith(PORT_SECTION)), None)
    if start is None:
        return 0, len(lines)
    end = next((j for j in range(start + 1, len(lines))
                if lines[j].startswith("## ")), len(lines))
    return start, end


def _doc_drift(defs: dict, env_names: set, defs_path: str) -> list:
    """README knob mentions that resolve to nothing — returned as raw
    Violations (no FileContext exists for markdown)."""
    from ray_tpu_torch._private.lint.core import RULES, Violation

    readme = _find_readme(defs_path)
    if readme is None:
        return []
    try:
        with open(readme, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    known = set(defs) | env_names
    out, seen = [], set()
    display = os.path.relpath(readme)
    start, end = _readme_region(lines)
    for i, line in enumerate(lines[start:end], start=start + 1):
        for m in _ENV_RE.finditer(line):
            name = m.group(1)
            if name in known or name in seen:
                continue
            seen.add(name)
            out.append(Violation(
                rule="TPU703", name=RULES["TPU703"], path=display,
                line=i, col=0,
                message=f"README documents RAY_TPU_{name} but no such "
                        "knob exists in CONFIG_DEFS (and no code touches "
                        "that env var) — stale docs after a rename/removal",
                scope="<readme>", snippet=line.strip()))
    return out


def finalize(states):
    defs: dict[str, int] = {}
    defs_state = None
    env_names: set = set()
    mentions_outside_defs: set = set()
    n_get_sites = 0
    for st in states:
        env_names |= st.env_names
        n_get_sites += len(st.gets)
        if st.defs and defs_state is None:
            defs, defs_state = st.defs, st
    for st in states:
        if st is not defs_state:
            mentions_outside_defs |= st.mentions
        # An explicit get is definitively a read even inside the defs
        # file, and a raw env read (flagged separately) still consumes
        # the knob — neither may ALSO report it dead.
        mentions_outside_defs |= {key for key, _, _ in st.gets}
    mentions_outside_defs |= env_names
    if not defs:
        return []

    for st in states:
        for key, line, scope in st.gets:
            if key not in defs:
                st.ctx.report(
                    "TPU703", protocol.FakeNode(line),
                    f"config.get({key!r}): unknown knob — not declared in "
                    "CONFIG_DEFS; this raises KeyError when the call "
                    "executes",
                    scope=scope)

    violations = []
    if n_get_sites:
        for knob in sorted(defs):
            if knob not in mentions_outside_defs:
                defs_state.ctx.report(
                    "TPU703", protocol.FakeNode(defs[knob]),
                    f"knob {knob!r} is declared in CONFIG_DEFS but never "
                    "read anywhere in the analyzed program — dead "
                    "configuration surface",
                    scope="CONFIG_DEFS")
    if defs_state.defs_is_config:
        violations.extend(
            _doc_drift(defs, env_names, defs_state.defs_real_path))
    return violations
