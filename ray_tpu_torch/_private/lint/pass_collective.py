"""TPU101/TPU102 — collective-divergence.

Collective ops are SPMD: every rank in the group must reach the same
call in the same order or the group deadlocks until the collective deadline
fires. Two statically-detectable shapes:

- TPU101: a collective call nested under a rank-dependent conditional
  (``if rank == 0:``, ``if self.is_head:``) — only some ranks reach it.
- TPU102: a collective call AFTER a rank-dependent early exit
  (``if rank != 0: return`` … ``barrier()``) — some ranks left the
  function before the rendezvous.

Flow-sensitive analysis (proving both branches issue matching ops) is
a ROADMAP follow-up; symmetric patterns are pragma'd today.
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint.core import FileContext, ScopeVisitor, dotted_name, iter_tree

COLLECTIVE_NAMES = frozenset({
    "allreduce", "allgather", "reduce", "reducescatter", "reduce_scatter",
    "broadcast", "barrier", "send", "recv", "sendrecv",
    # The async verbs dispatch the op immediately — a guarded
    # dispatch diverges exactly like a guarded sync verb.
    "allreduce_async", "reducescatter_async", "allgather_async",
    "hierarchical_allreduce",
})
# Attribute-form calls (x.barrier()) need the receiver to look like a
# collective module/group — `sock.send()` must not trip the pass.
_RECEIVER_HINTS = ("col", "collective", "comm", "group", "grp")
_RANK_TOKENS = ("rank", "is_head", "is_leader", "is_coordinator")


def _collective_modules(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(aliases of ray_tpu_torch.collective, names imported from it)."""
    aliases: set[str] = set()
    names: set[str] = set()
    for node in iter_tree(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] == "collective":
                    aliases.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.split(".")[-1] == "collective":
                for a in node.names:
                    if a.name in COLLECTIVE_NAMES:
                        names.add(a.asname or a.name)
    return aliases, names


def is_rank_dependent(test: ast.AST) -> bool:
    for node in iter_tree(test):
        name = ""
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and any(t in name.lower() for t in _RANK_TOKENS):
            return True
    return False


class _Visitor(ScopeVisitor):
    def __init__(self, ctx: FileContext):
        super().__init__(ctx)
        self._aliases, self._imported = _collective_modules(ctx.tree)
        self._guard_depth = 0
        # Per-function stack: line of the latest rank-dependent early
        # exit seen so far (None until one is found).
        self._early_exit: list[tuple[int, str] | None] = []

    # ------------------------------------------------------ helpers
    def _is_collective(self, call: ast.Call) -> str | None:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in self._imported:
                return func.id
            return None
        if isinstance(func, ast.Attribute) and func.attr in COLLECTIVE_NAMES:
            recv = dotted_name(func.value)
            last = recv.split(".")[-1].lower() if recv else ""
            if recv.split(".")[0] in self._aliases:
                return func.attr
            if any(h in last for h in _RECEIVER_HINTS):
                return func.attr
        return None

    @staticmethod
    def _branch_exits(body: list[ast.stmt]) -> bool:
        return bool(body) and isinstance(
            body[-1], (ast.Return, ast.Break, ast.Continue, ast.Raise))

    # ------------------------------------------------------ visitors
    def enter_function(self, node):
        self._early_exit.append(None)

    def exit_function(self, node):
        self._early_exit.pop()

    def _visit_guarded(self, node):
        """Shared If/While handling: push guard depth around
        rank-dependent branches, record early exits."""
        rank_dep = is_rank_dependent(node.test)
        if rank_dep and isinstance(node, ast.If) and self._early_exit:
            for branch in (node.body, node.orelse):
                if self._branch_exits(branch):
                    self._early_exit[-1] = (
                        node.lineno,
                        type(branch[-1]).__name__.lower(),
                    )
        if rank_dep:
            self._guard_depth += 1
        self.visit(node.test)
        for stmt in node.body:
            self.visit(stmt)
        for stmt in node.orelse:
            self.visit(stmt)
        if rank_dep:
            self._guard_depth -= 1

    def visit_If(self, node: ast.If):
        self._visit_guarded(node)

    def visit_While(self, node: ast.While):
        self._visit_guarded(node)

    def visit_Call(self, node: ast.Call):
        verb = self._is_collective(node)
        if verb is not None:
            if self._guard_depth > 0:
                self.ctx.report(
                    "TPU101", node,
                    f"collective op `{verb}` under a rank-dependent "
                    "conditional: ranks that skip the branch never join "
                    "the rendezvous (SPMD deadlock)",
                    scope=self.scope,
                )
            elif self._early_exit and self._early_exit[-1] is not None:
                line, kind = self._early_exit[-1]
                self.ctx.report(
                    "TPU102", node,
                    f"collective op `{verb}` after the rank-dependent "
                    f"early `{kind}` on line {line}: exited ranks never "
                    "reach this rendezvous",
                    scope=self.scope,
                )
        self.generic_visit(node)


def run(ctx: FileContext):
    # Every detectable call site names a collective verb textually —
    # attribute form at the call, from-import form on the import line
    # (even when aliased) — and both TPU101 and TPU102 additionally
    # need a rank-dependent test, whose name carries a rank token.
    if not any(name in ctx.source for name in COLLECTIVE_NAMES):
        return None
    lowered = ctx.source.lower()
    if not any(t in lowered for t in _RANK_TOKENS):
        return None
    _Visitor(ctx).visit(ctx.tree)
    return None


def finalize(states):
    return []
