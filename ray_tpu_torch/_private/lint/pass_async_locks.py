"""TPU203 — async-lock discipline.

Three shapes where locks and the event loop interact badly:

- **threading lock across ``await``**: a ``with self._lock:`` block in
  an ``async def`` that awaits inside the critical section. The
  coroutine suspends holding an OS lock; every *thread* that wants the
  lock stalls for an arbitrary number of scheduler turns — and if one
  of those threads is the loop's own executor, the loop deadlocks.
  (Moved here from TPU201: the fix is different — switch to
  ``asyncio.Lock`` or shrink the section — so it gets its own id.)
- **blocking call inside an ``asyncio.Lock`` section**: ``async with
  self._lock:`` around ``time.sleep`` / subprocess / blocking RPC
  freezes the whole event loop while every other coroutine queues on
  the lock — the single-threaded twin of TPU201.
- **unbalanced manual acquire in ``async def``**: ``await
  lk.acquire()`` (or ``lk.acquire()``) where some return path skips
  ``release()``. With coroutines, the "other path" is usually an early
  return after an awaited call raised — the lock stays held forever
  because no stack unwind releases it. Use ``async with`` (flagged
  clean), or release in a ``finally``.

Lock detection is name-based like TPU201/202 (``lock``/``mutex`` in
the last name component); ``async with`` implies an asyncio lock,
plain ``with`` implies a threading lock."""

from __future__ import annotations

import ast

from ray_tpu_torch._private.lint import dataflow
from ray_tpu_torch._private.lint.core import FileContext, iter_tree
from ray_tpu_torch._private.lint.pass_locks import _lock_expr_name


class _State(dataflow.PathState):
    __slots__ = ("held_sync", "held_async", "manual")

    def __init__(self):
        self.held_sync: tuple = ()     # threading locks via `with`
        self.held_async: tuple = ()    # asyncio locks via `async with`
        self.manual: dict[str, int] = {}   # lock name -> acquire line

    def fork(self):
        st = _State()
        st.held_sync = self.held_sync
        st.held_async = self.held_async
        st.manual = dict(self.manual)
        return st

    def merge(self, other):
        # A lock held on EITHER joining path is held on the join: the
        # imbalance check fires at exits, where "held on some path" is
        # exactly the bug.
        for name, line in other.manual.items():
            self.manual.setdefault(name, line)


class _Walker(dataflow.FlowWalker):
    def __init__(self, ctx: FileContext, scope: str, fn_node,
                 blocking_reason):
        self.ctx = ctx
        self.scope = scope
        self.is_async = True
        self._blocking_reason = blocking_reason
        self._reported: set[tuple] = set()
        self.releases: set[str] = set()   # lock names released anywhere
        # Calls that are the direct operand of `await` are loop-friendly
        # by construction — `await client.call(...)` must not read as a
        # blocking RPC.
        self._awaited: set[int] = set()
        for node in iter_tree(fn_node):
            if isinstance(node, ast.Await) and isinstance(
                    node.value, ast.Call):
                self._awaited.add(id(node.value))

    def _report(self, key, line, message):
        if key in self._reported:
            return
        self._reported.add(key)
        self.ctx.report("TPU203", _node(line), message, scope=self.scope)

    # ------------------------------------------------------------ with
    def on_with(self, item, state, is_async):
        name = _lock_expr_name(item.context_expr)
        if name is None:
            return None
        if is_async:
            state.held_async = state.held_async + (name,)
            return ("async", name)
        state.held_sync = state.held_sync + (name,)
        return ("sync", name)

    def on_with_exit(self, token, state):
        if token is None:
            return
        kind, name = token
        if kind == "async" and state.held_async:
            state.held_async = state.held_async[:-1]
        elif kind == "sync" and state.held_sync:
            state.held_sync = state.held_sync[:-1]

    # ----------------------------------------------------------- events
    def on_await(self, node, state):
        if state.held_sync:
            self._report(
                ("await", node.lineno),
                node.lineno,
                f"`await` while holding threading lock "
                f"`{state.held_sync[-1]}`: the coroutine suspends with "
                "an OS lock held — every thread needing it stalls for "
                "arbitrarily many scheduler turns; use asyncio.Lock "
                "or move the await outside the section",
            )

    def on_call(self, call, state):
        func = call.func
        if isinstance(func, ast.Attribute):
            name = _lock_expr_name(func.value)
            if name is not None and self.is_async:
                if func.attr == "acquire":
                    state.manual.setdefault(name, call.lineno)
                elif func.attr == "release":
                    state.manual.pop(name, None)
                    self.releases.add(name)
        if state.held_async and id(call) not in self._awaited:
            reason = self._blocking_reason(call)
            if reason is not None:
                self._report(
                    ("block", call.lineno),
                    call.lineno,
                    f"{reason} inside asyncio lock section "
                    f"`{state.held_async[-1]}`: the event loop freezes "
                    "while every coroutine queued on the lock waits — "
                    "await an executor instead",
                )

    def on_exit(self, state, node, kind):
        if kind not in ("return", "fall"):
            return
        for name, line in state.manual.items():
            if name in self.releases:
                self._report(
                    ("imbalance", line, name),
                    line,
                    f"`{name}.acquire()` here is released on another "
                    "path but not on the one reaching line "
                    f"{getattr(node, 'lineno', line)}: the lock stays "
                    "held forever on this path — release in a "
                    "`finally` or use `async with`",
                )
            else:
                self._report(
                    ("never-released", line, name),
                    line,
                    f"`{name}.acquire()` in async def is never "
                    "released: no stack unwind frees a manually "
                    "acquired lock — use `async with` or release in "
                    "a `finally`",
                )


def _node(line: int):
    class N:
        lineno = line
        col_offset = 0
    return N


def run(ctx: FileContext):
    src = ctx.source
    if "async" not in src:
        return None
    from ray_tpu_torch._private.lint.pass_locks import _Visitor as _LockVisitor

    # Borrow TPU201's blocking-call classifier without re-instantiating
    # its full state machine.
    classifier = _LockVisitor(ctx)
    mi = dataflow.index(ctx)
    for info in mi.functions.values():
        # Every TPU203 shape needs `await`/`async with`/a coroutine
        # acquire — all exclusive to async defs; skip the rest.
        if not info.is_async:
            continue
        scope = (f"{info.class_name}.{info.node.name}"
                 if info.class_name else info.node.name)
        walker = _Walker(ctx, scope, info.node,
                         classifier._blocking_reason)
        walker.walk_function(info.node, _State())
    return None


def finalize(states):
    return []
