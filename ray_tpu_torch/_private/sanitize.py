"""Runtime concurrency sanitizer: instrumented locks.

The static side (``ray_tpu_torch/_private/lint``) catches lock-order cycles
it can SEE; this module is the dynamic backstop for the ones it can't
(locks passed through data structures, order established across
callbacks). An ``InstrumentedLock`` records, per thread, the stack of
instrumented locks held at each acquisition and feeds a global
lock-order graph:

- acquiring B while holding A adds edge A→B; if B→…→A already exists,
  the acquisition raises :class:`LockOrderViolation` NAMING the cycle —
  at the acquisition that would deadlock, not minutes later when two
  threads actually interleave.
- releasing a lock held longer than ``RAY_TPU_SANITIZE_HOLD_MS``
  (default 100) logs a warning with the hold duration — the
  blocking-while-holding shape TPU201 flags statically.

Runtime twins of the v2 flow-sensitive lint passes:

- **async-lock awareness (TPU203's twin)**: :class:`InstrumentedLock`
  warns when a *blocking* acquire happens on a thread that is running
  an asyncio event loop (the loop freezes for every coroutine), and
  :class:`InstrumentedAsyncLock` puts ``asyncio.Lock`` acquisitions
  into the SAME order graph as the threading locks — a sync/async
  lock inversion is still an inversion.
- **leak reporter (TPU104/TPU404's twin)**: :func:`watch_work` /
  :func:`watch_registration` attach a ``weakref.finalize`` to a
  :class:`~ray_tpu_torch.collective.types.CollectiveWork` or a
  ``memory.Registration``; if the object is garbage-collected
  un-``wait()``ed / un-``close()``d, a warning names what was
  dropped. The static passes catch the paths they can see — this
  catches the handles that escaped into data structures.

The JAX package's jit compile watch and host-sync tracer (which patch
``jax.jit``, ``jax.block_until_ready`` and ``jax.device_get``) have no
counterpart here: the port compiles nothing.

Opt-in: ``RAY_TPU_SANITIZE=1`` makes :func:`maybe_lock` /
:func:`maybe_rlock` / :func:`maybe_async_lock` hand out instrumented
locks, enables the leak watchers, and :func:`install` monkeypatches
``threading.Lock``/``RLock`` so locks allocated by ray_tpu_torch code during
the install window are instrumented (allocation-site filtered:
third-party/stdlib locks are left alone — their internal ordering
conventions are not ours to police). ``RAY_TPU_SANITIZE_LEAKS=1``
enables just the leak watchers. ``tests/conftest.py`` installs the
lock side for the chaos / fault-tolerance modules.
"""

from __future__ import annotations

import _thread
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

_DEFAULT_HOLD_MS = 100.0


class LockOrderViolation(RuntimeError):
    """Acquiring this lock here can deadlock: the lock-order graph
    already contains a path back to a lock this thread holds."""

    def __init__(self, cycle: list[str], holder_hint: str = ""):
        self.cycle = cycle
        msg = " -> ".join(cycle)
        if holder_hint:
            msg += f" ({holder_hint})"
        super().__init__(f"lock-order cycle: {msg}")


def enabled() -> bool:
    # tpulint: allow(TPU703 reason=the sanitizer is the independent backstop — its gate must not depend on the config machinery it may be diagnosing)
    return os.environ.get("RAY_TPU_SANITIZE", "") == "1"


def _hold_threshold_s() -> float:
    try:
        return float(
            # tpulint: allow(TPU703 reason=sanitizer knobs stay env-only so the backstop works even when config loading is itself broken)
            os.environ.get("RAY_TPU_SANITIZE_HOLD_MS", _DEFAULT_HOLD_MS)
        ) / 1000.0
    except ValueError:
        return _DEFAULT_HOLD_MS / 1000.0


class _OrderGraph:
    """Global lock-order graph. Guarded by a RAW lock (allocated via
    _thread, never instrumented: the sanitizer must not sanitize its
    own plumbing into infinite recursion)."""

    def __init__(self):
        self._guard = _thread.allocate_lock()
        self._edges: dict[int, set[int]] = {}
        self._names: dict[int, str] = {}
        self.cycles_detected = 0
        self.long_holds = 0
        self.loop_thread_acquires = 0
        self.work_leaks = 0
        self.registration_leaks = 0
        self.recompiles = 0
        self.host_syncs = 0
        self.rpc_contract_misses = 0

    def reset(self):
        with self._guard:
            self._edges.clear()
            self._names.clear()
            self.cycles_detected = 0
            self.long_holds = 0
            self.loop_thread_acquires = 0
            self.work_leaks = 0
            self.registration_leaks = 0
            self.recompiles = 0
            self.host_syncs = 0
            self.rpc_contract_misses = 0

    def check_and_add(self, held_id: int, held_name: str,
                      new_id: int, new_name: str) -> list[str] | None:
        """Add edge held→new; return the cycle as names if one forms."""
        with self._guard:
            self._names[held_id] = held_name
            self._names[new_id] = new_name
            # Path new → … → held already present means held→new closes
            # a cycle.
            path = self._find_path(new_id, held_id)
            if path is not None:
                self.cycles_detected += 1
                names = [self._names.get(n, f"lock@{n:#x}")
                         for n in [held_id] + path]
                return names
            self._edges.setdefault(held_id, set()).add(new_id)
            return None

    def _find_path(self, src: int, dst: int) -> list[int] | None:
        if src == dst:
            return [src]
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


_graph = _OrderGraph()
_tls = threading.local()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class InstrumentedLock:
    """Drop-in for ``threading.Lock``/``RLock`` with order tracking."""

    def __init__(self, name: str | None = None, reentrant: bool = False,
                 hold_threshold_s: float | None = None):
        # The ORIGINAL factories: threading.Lock/RLock may be patched
        # to _patched_lock while install() is active — building the
        # inner lock through them would recurse.
        self._inner = _ORIG_RLOCK() if reentrant else _ORIG_LOCK()
        self.name = name or f"lock@{id(self):#x}"
        self.reentrant = reentrant
        self._hold_threshold_s = (
            hold_threshold_s if hold_threshold_s is not None
            else _hold_threshold_s()
        )
        # owner bookkeeping for reentrancy / hold timing
        self._acquired_at: dict[int, float] = {}
        self._depth: dict[int, int] = {}

    # ------------------------------------------------------- acquire
    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = _thread.get_ident()
        stack = _held_stack()
        if blocking and _on_event_loop_thread():
            # TPU203's runtime twin: a blocking lock acquire on the
            # loop thread freezes every coroutine until it's granted.
            _graph.loop_thread_acquires += 1
            logger.warning(
                "sanitizer: blocking acquire of %s on an event-loop "
                "thread (%s) — the loop (and every coroutine on it) "
                "stalls until the lock is granted; use asyncio.Lock "
                "or run the critical section in an executor",
                self.name, threading.current_thread().name,
            )
        if self.reentrant and self._depth.get(me, 0) > 0:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._depth[me] += 1
            return got
        for held in stack:
            if held is self:
                continue
            cycle = _graph.check_and_add(
                id(held), held.name, id(self), self.name)
            if cycle is not None:
                raise LockOrderViolation(
                    cycle,
                    holder_hint=(
                        f"thread {threading.current_thread().name} "
                        f"holds {held.name}, wants {self.name}"
                    ),
                )
        got = self._inner.acquire(blocking, timeout)
        if got:
            stack.append(self)
            self._acquired_at[me] = time.monotonic()
            if self.reentrant:
                self._depth[me] = 1
        return got

    def release(self):
        me = _thread.get_ident()
        if self.reentrant and self._depth.get(me, 0) > 1:
            self._depth[me] -= 1
            self._inner.release()
            return
        t0 = self._acquired_at.pop(me, None)
        self._depth.pop(me, None)
        stack = _held_stack()
        if self in stack:
            stack.remove(self)
        self._inner.release()
        if t0 is not None:
            held_s = time.monotonic() - t0
            if held_s > self._hold_threshold_s:
                _graph.long_holds += 1
                logger.warning(
                    "sanitizer: %s held for %.0f ms (> %.0f ms) by "
                    "thread %s — was something blocking inside the "
                    "critical section?",
                    self.name, held_s * 1e3,
                    self._hold_threshold_s * 1e3,
                    threading.current_thread().name,
                )

    # ------------------------------------------------------ protocol
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked() if hasattr(
            self._inner, "locked") else False

    def __repr__(self):
        kind = "RLock" if self.reentrant else "Lock"
        return f"<InstrumentedLock {kind} {self.name!r}>"


_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_install_count = 0


def _on_event_loop_thread() -> bool:
    try:
        import asyncio
        return asyncio.events._get_running_loop() is not None
    # tpulint: allow(broad-except reason=the loop probe is best-effort diagnostics; any asyncio internals change must degrade to "not on a loop", never break lock acquisition)
    except Exception:  # noqa: BLE001
        return False


class InstrumentedAsyncLock:
    """``asyncio.Lock`` twin of :class:`InstrumentedLock`: acquisitions
    join the SAME global order graph (checked against both the locks
    this *task* holds and the threading locks this *thread* holds — a
    sync/async inversion deadlocks just as hard), and holds longer
    than the threshold warn on release."""

    def __init__(self, name: str | None = None,
                 hold_threshold_s: float | None = None):
        import asyncio

        self._inner = asyncio.Lock()
        self.name = name or f"alock@{id(self):#x}"
        self._hold_threshold_s = (
            hold_threshold_s if hold_threshold_s is not None
            else _hold_threshold_s()
        )
        self._acquired_at: float | None = None

    def _check_order(self):
        holders = list(_task_held_stack()) + list(_held_stack())
        for held in holders:
            if held is self:
                continue
            cycle = _graph.check_and_add(
                id(held), held.name, id(self), self.name)
            if cycle is not None:
                raise LockOrderViolation(
                    cycle,
                    holder_hint=(
                        f"task holds {held.name}, wants {self.name}"
                    ),
                )

    async def acquire(self):
        self._check_order()
        got = await self._inner.acquire()
        _task_held_stack().append(self)
        self._acquired_at = time.monotonic()
        return got

    def release(self):
        stack = _task_held_stack()
        if self in stack:
            stack.remove(self)
        t0, self._acquired_at = self._acquired_at, None
        self._inner.release()
        if t0 is not None:
            held_s = time.monotonic() - t0
            if held_s > self._hold_threshold_s:
                _graph.long_holds += 1
                logger.warning(
                    "sanitizer: %s held for %.0f ms (> %.0f ms) — was "
                    "something blocking inside the async critical "
                    "section?",
                    self.name, held_s * 1e3,
                    self._hold_threshold_s * 1e3,
                )

    def locked(self):
        return self._inner.locked()

    async def __aenter__(self):
        await self.acquire()
        return self

    async def __aexit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<InstrumentedAsyncLock {self.name!r}>"


# Per-task held stacks for async locks; keyed by task id, pruned on
# release (a finished task's entry dies with its last release — tasks
# that leak a lock leak one list entry, which the leak warning already
# shouts about).
_task_held: dict[int, list] = {}


def _task_held_stack() -> list:
    try:
        import asyncio
        task = asyncio.current_task()
    # tpulint: allow(broad-except reason=outside a running loop there is no task; order checks then cover only thread-held locks)
    except Exception:  # noqa: BLE001
        task = None
    if task is None:
        return _held_stack()
    key = id(task)
    stack = _task_held.get(key)
    if stack is None:
        stack = _task_held[key] = []
    elif not stack:
        # opportunistic prune of empty entries from finished tasks
        for k in [k for k, v in _task_held.items() if not v and k != key]:
            del _task_held[k]
    return stack


# --------------------------------------------------------- leak reporter
def leaks_enabled() -> bool:
    # tpulint: allow(TPU703 reason=sanitizer knobs stay env-only so the backstop works even when config loading is itself broken)
    return enabled() or os.environ.get(
        "RAY_TPU_SANITIZE_LEAKS", "") == "1"


def watch_work(handle) -> None:
    """Warn if ``handle`` (a CollectiveWork) is GC'd before any
    ``wait()`` reached a terminal outcome: the dispatched collective's
    result — and any typed fault — was silently dropped. Wired into
    ``CollectiveWork.__init__`` when :func:`leaks_enabled`."""
    import weakref

    box = {
        "closed": False,
        "desc": f"{handle.verb or 'op'} group="
                f"{handle.group_name or '?'}",
    }
    handle._leak_box = box
    weakref.finalize(handle, _report_work_leak, box)


def _report_work_leak(box):
    if box["closed"]:
        return
    _graph.work_leaks += 1
    logger.warning(
        "sanitizer: CollectiveWork (%s) garbage-collected without a "
        "completed wait() — the dispatched collective's result and "
        "typed errors were silently dropped (TPU104's runtime twin)",
        box["desc"],
    )


def watch_registration(reg) -> None:
    """Warn if a memory-ledger Registration is GC'd still open: the
    byte claim silently outlives its subsystem and the device-memory
    ledger over-reports. Wired into ``memory.track()`` when
    :func:`leaks_enabled`."""
    import weakref

    box = {"closed": False, "desc": f"{reg.tag} kind={reg.kind}"}
    reg._leak_box = box
    weakref.finalize(reg, _report_registration_leak, box)


def _report_registration_leak(box):
    if box["closed"]:
        return
    _graph.registration_leaks += 1
    logger.warning(
        "sanitizer: memory Registration (%s) garbage-collected while "
        "still open — the byte claim was never close()d and the "
        "device-memory ledger over-reports (TPU404's runtime twin)",
        box["desc"],
    )


def maybe_lock(name: str | None = None):
    """threading.Lock(), instrumented when RAY_TPU_SANITIZE=1."""
    if enabled() or _install_count:
        return InstrumentedLock(name=name)
    return _ORIG_LOCK()


def maybe_rlock(name: str | None = None):
    if enabled() or _install_count:
        return InstrumentedLock(name=name, reentrant=True)
    return _ORIG_RLOCK()


def maybe_async_lock(name: str | None = None):
    """asyncio.Lock(), instrumented when RAY_TPU_SANITIZE=1."""
    if enabled() or _install_count:
        return InstrumentedAsyncLock(name=name)
    import asyncio

    return asyncio.Lock()


def _caller_module(depth: int = 2) -> str:
    import sys
    try:
        frame = sys._getframe(depth)
        return frame.f_globals.get("__name__", "")
    except ValueError:
        return ""


def _patched_lock():
    mod = _caller_module()
    if mod.startswith("ray_tpu_torch") or mod.startswith("test"):
        return InstrumentedLock(name=f"{mod}.Lock@{_site_tag()}")
    return _ORIG_LOCK()


def _patched_rlock():
    mod = _caller_module()
    if mod.startswith("ray_tpu_torch") or mod.startswith("test"):
        return InstrumentedLock(
            name=f"{mod}.RLock@{_site_tag()}", reentrant=True)
    return _ORIG_RLOCK()


def _site_tag() -> str:
    import sys
    try:
        frame = sys._getframe(3)
        return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    except ValueError:
        return "?"


def install():
    """Monkeypatch threading.Lock/RLock: locks allocated by ray_tpu_torch /
    tests code while installed come back instrumented. Reference-
    counted so nested installs (fixture + explicit) compose."""
    global _install_count
    _install_count += 1
    if _install_count == 1:
        threading.Lock = _patched_lock
        threading.RLock = _patched_rlock


def uninstall():
    global _install_count
    if _install_count == 0:
        return
    _install_count -= 1
    if _install_count == 0:
        threading.Lock = _ORIG_LOCK
        threading.RLock = _ORIG_RLOCK


# ---------------------------------------------- rpc contract twin
# Runtime twin of the TPU701 static pass: validate Connection.call
# kwargs against the handler signature table the lint model exports.
# The static pass catches drift it can resolve at analysis time; this
# catches the call sites it can't (f-string methods, kwargs-dict
# splats) — warn-only, because tolerant_kwargs dropping unknown kwargs
# IS the deployed version-skew behavior; the sanitizer's job is to
# make the silence visible.

_contract_table: dict | None = None
_contract_warned: set = set()
_contract_guard = _thread.allocate_lock()
# Mirrors lint.protocol.TRANSPORT_KWARGS without importing the lint
# package at module load.
_TRANSPORT_KWARGS = frozenset({"timeout", "retry"})


def _handler_table() -> dict:
    """Lazily build (once) the package-wide handler signature table.
    Any failure degrades to an empty table — the sanitizer must never
    turn a working RPC path into a crash."""
    global _contract_table
    if _contract_table is None:
        try:
            from ray_tpu_torch._private.lint import protocol
            _contract_table = protocol.handler_signature_table()
        except Exception as e:
            logger.debug("rpc contract table build failed "
                         "(contract checks disabled): %s", e)
            _contract_table = {}
    return _contract_table


def check_rpc_contract(method: str, kw: dict) -> None:
    """Warn (once per method+kind, counting every miss) when a call's
    method or kwargs don't match any known ``_on_<method>`` handler."""
    if ":" in method:
        return  # extension namespaces (col_op:<name>) are dynamic
    table = _handler_table()
    sig = table.get(method)
    problems: list[tuple[str, str]] = []
    if sig is None:
        problems.append((
            "unknown-method",
            f"rpc contract: call({method!r}) matches no _on_{method} "
            "handler anywhere in the package — the server will raise "
            "unknown-method at dispatch",
        ))
    else:
        unknown = set(kw) - sig["params"] - _TRANSPORT_KWARGS
        if unknown and not sig["varkw"]:
            problems.append((
                "unknown-kwarg",
                f"rpc contract: call({method!r}) passes "
                f"{sorted(unknown)} which _on_{method} does not "
                "accept — tolerant_kwargs silently DROPS them on the "
                "server",
            ))
        missing = sig["required"] - set(kw)
        if missing:
            problems.append((
                "missing-required",
                f"rpc contract: call({method!r}) omits required "
                f"parameter(s) {sorted(missing)} of _on_{method} — "
                "the handler raises TypeError at dispatch",
            ))
    if not problems:
        return
    with _contract_guard:
        _graph.rpc_contract_misses += len(problems)
        fresh = [(kind, msg) for kind, msg in problems
                 if (method, kind) not in _contract_warned]
        _contract_warned.update((method, kind) for kind, _ in fresh)
    for _, msg in fresh:
        logger.warning(msg)


def reset():
    """Clear the global order graph (test isolation: one module's lock
    order must not poison the next's)."""
    _graph.reset()
    with _contract_guard:
        _contract_warned.clear()


def stats() -> dict:
    return {
        "cycles_detected": _graph.cycles_detected,
        "long_holds": _graph.long_holds,
        "loop_thread_acquires": _graph.loop_thread_acquires,
        "work_leaks": _graph.work_leaks,
        "registration_leaks": _graph.registration_leaks,
        "recompiles": _graph.recompiles,
        "host_syncs": _graph.host_syncs,
        "rpc_contract_misses": _graph.rpc_contract_misses,
        "edges": sum(len(v) for v in _graph._edges.values()),
    }
