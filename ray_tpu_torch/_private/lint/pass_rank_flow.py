"""TPU103 — flow-sensitive, interprocedural rank divergence.

TPU101/102 see a collective call only when the verb is syntactically at
the guarded site. The moment the collective moves into a helper::

    def _sync(self):
        col.allreduce(self.grads)      # innocent on its own

    def step(self):
        if self.rank == 0:
            self._sync()               # SPMD hang — invisible to TPU101

the old pass goes blind. TPU103 closes that hole: the dataflow engine's
call graph computes the set of functions that *transitively* issue a
collective op, and a flow-sensitive walk flags any call into that set
made (a) under a rank-/``slice_label``-dependent branch or (b) on a
path that survives a rank-dependent early exit. Direct collective calls
stay TPU101/102 (one site, one rule)."""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import dataflow
from ray_tpu_torch._private.lint.core import FileContext, iter_tree
from ray_tpu_torch._private.lint.pass_collective import (
    COLLECTIVE_NAMES,
    _RANK_TOKENS,
    _RECEIVER_HINTS,
    is_rank_dependent,
)
from ray_tpu_torch._private.lint.core import dotted_name

# slice_label is the fault-domain twin of rank: a collective
# guarded by "which slice am I on" diverges exactly like a rank guard.
_FLOW_TOKENS = tuple(_RANK_TOKENS) + ("slice_label", "slice_index")


def _is_divergence_test(test: ast.AST) -> bool:
    if is_rank_dependent(test):
        return True
    for node in iter_tree(test):
        name = ""
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and any(t in name.lower() for t in _FLOW_TOKENS):
            return True
    return False


def _is_direct_collective(call: ast.Call, imported: set[str],
                          aliases: set[str]) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in imported
    if isinstance(func, ast.Attribute) and func.attr in COLLECTIVE_NAMES:
        recv = dotted_name(func.value)
        last = recv.split(".")[-1].lower() if recv else ""
        if recv and recv.split(".")[0] in aliases:
            return True
        return any(h in last for h in _RECEIVER_HINTS)
    return False


class _State(dataflow.PathState):
    __slots__ = ("guards", "early_exit")

    def __init__(self):
        self.guards: tuple = ()          # lines of active rank guards
        self.early_exit: tuple | None = None   # (line, kind)

    def fork(self):
        st = _State()
        st.guards = self.guards
        st.early_exit = self.early_exit
        return st

    def merge(self, other):
        # Joining with a path that carries an early-exit taint keeps
        # the taint: SOME ranks may have left before this point.
        if self.early_exit is None:
            self.early_exit = other.early_exit


class _Walker(dataflow.FlowWalker):
    def __init__(self, pass_state, mi: dataflow.ModuleIndex,
                 info: dataflow.FunctionInfo,
                 imported: set[str], aliases: set[str]):
        self.pass_state = pass_state
        self.mi = mi
        self.info = info
        self._imported = imported
        self._aliases = aliases

    def on_branch(self, test, state, taken):
        if _is_divergence_test(test):
            state.guards = state.guards + (test.lineno,)
            return True
        return None

    def on_branch_exit(self, token, state):
        if token and state.guards:
            state.guards = state.guards[:-1]

    def on_if_join(self, stmt, state, then_exited, else_exited):
        if state is None or not _is_divergence_test(stmt.test):
            return
        if then_exited or else_exited:
            arm = stmt.body if then_exited else stmt.orelse
            kind = type(arm[-1]).__name__.lower() if arm else "return"
            state.early_exit = (stmt.lineno, kind)

    def on_call(self, call, state):
        if not state.guards and state.early_exit is None:
            return
        if _is_direct_collective(call, self._imported, self._aliases):
            return  # TPU101/102 own the direct-call shape
        callee = self.mi.resolve_call(call, self.info.class_name)
        if callee is None:
            return
        self.pass_state.events.append((
            self.info.ctx, callee, call.lineno,
            tuple(state.guards), state.early_exit, self.info.qual,
            self._scope(),
        ))

    def _scope(self):
        if self.info.class_name:
            return f"{self.info.class_name}.{self.info.node.name}"
        return self.info.node.name


class _PassState:
    def __init__(self, mi: dataflow.ModuleIndex):
        self.mi = mi
        # (ctx, callee, line, guard_lines, early_exit, caller, scope)
        self.events: list[tuple] = []
        # fn quals in this module that DIRECTLY call a collective verb
        self.direct: set[str] = set()


def _collective_import_context(nodes):
    aliases: set[str] = set()
    names: set[str] = set()
    for node in nodes:
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


def run(ctx: FileContext):
    # Cheap textual pre-filter: no collective verb token anywhere means
    # no function here can be (or call) an issuer this module observes.
    src = ctx.source
    if not any(v in src for v in ("allreduce", "allgather", "barrier",
                                  "reducescatter", "broadcast",
                                  "sendrecv")):
        interesting = False
    else:
        interesting = True
    mi = dataflow.index(ctx)
    st = _PassState(mi)
    aliases, imported = _collective_import_context(ctx.nodes)
    for qual, info in mi.functions.items():
        if interesting:
            for node in iter_tree(info.node):
                if isinstance(node, ast.Call) and _is_direct_collective(
                        node, imported, aliases):
                    st.direct.add(qual)
                    break
    # Flow walk every function that contains a divergence token — the
    # events only matter if a guard is live.
    lowered = src.lower()
    if any(t in lowered for t in _FLOW_TOKENS):
        for info in mi.functions.values():
            walker = _Walker(st, mi, info, imported, aliases)
            walker.walk_function(info.node, _State())
    return st


def finalize(states):
    program = dataflow.Program([st.mi for st in states])
    direct: set[str] = set()
    for st in states:
        direct.update(st.direct)
    if not direct:
        return []
    issuers = program.closure(direct)
    seen: set[tuple] = set()  # loop bodies are walked twice — dedupe
    for st in states:
        for (ctx, callee, line, guards, early_exit, caller,
             scope) in st.events:
            if callee not in issuers:
                continue
            if callee not in program.functions:
                continue  # unresolved foreign name that happens to match
            key = (id(ctx), line, callee)
            if key in seen:
                continue
            seen.add(key)
            if guards:
                ctx.report(
                    "TPU103", _FakeNode(line),
                    f"`{callee}()` transitively issues a collective op "
                    f"but is called under a rank-/slice-dependent "
                    f"branch (guard at line {guards[-1]}): ranks that "
                    "skip this path never join the rendezvous (SPMD "
                    "hang hidden behind a helper)",
                    scope=scope,
                )
            elif early_exit is not None:
                ex_line, kind = early_exit
                ctx.report(
                    "TPU103", _FakeNode(line),
                    f"`{callee}()` transitively issues a collective op "
                    f"after the rank-dependent early `{kind}` on line "
                    f"{ex_line}: exited ranks never reach the "
                    "rendezvous inside the helper",
                    scope=scope,
                )
    return []


class _FakeNode:
    """Line-only node stand-in for ctx.report (events outlive their
    ast nodes cheaply this way)."""

    __slots__ = ("lineno", "col_offset")

    def __init__(self, lineno: int, col: int = 0):
        self.lineno = lineno
        self.col_offset = col
