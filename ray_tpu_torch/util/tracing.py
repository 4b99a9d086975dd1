"""Distributed tracing (reference:
python/ray/util/tracing/tracing_helper.py — the global switch
`_global_is_tracing_enabled` :88, remote-call wrapping + context
injection into task metadata `_start_span` :411). Spans ride the
existing task-event pipeline to the head (no OpenTelemetry daemon), and
`torch_profile` hooks torch.profiler for on-device traces, as the
reference's torch-profiler hooks do (compiled_dag_node.py:207ff).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
import uuid

_enabled = False
# (trace_id, span_id) of the span this code runs under.
_current: contextvars.ContextVar[tuple[str, str] | None] = (
    contextvars.ContextVar("ray_tpu_trace", default=None)
)
# Driver-thread spans: .remote() captures context on the CALLER's thread
# before hopping to the runtime loop, so span() records here too
# (contextvars do not cross run_coroutine_threadsafe).
_tl = threading.local()


def enable_tracing() -> None:
    """Turn on span collection for this process's submits (workers
    inherit per-task context through the task spec)."""
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def is_tracing_enabled() -> bool:
    from ray_tpu_torch._private import config

    return _enabled or config.get("TRACE")


def current_context() -> tuple[str, str] | None:
    return _current.get()


def active_context() -> tuple[str, str] | None:
    """Public view of the active span — the contextvar when set, else
    this thread's scope (see _active). What serve's request path ships
    across the handle→replica hop so spans parent correctly."""
    return _active()


def _active() -> tuple[str, str] | None:
    """Current span: the contextvar when set, else this thread's scope
    (span() on driver threads; the worker sets it per executor thread via
    thread_trace before running a sync task, so concurrent actor tasks
    each see their OWN span — no shared process-wide slot)."""
    cur = _current.get()
    if cur is not None:
        return cur
    return getattr(_tl, "cur", None)


@contextlib.contextmanager
def thread_trace(ctx: tuple[str, str] | None):
    """Install `ctx` as this THREAD's active span. Used by the worker to
    carry a task's trace context onto the executor thread that runs its
    sync function (contextvars do not cross run_in_executor); keyed to
    the thread, so interleaved finishes of concurrent traced tasks can't
    restore each other's context."""
    prev = getattr(_tl, "cur", None)
    _tl.cur = ctx
    try:
        yield
    finally:
        _tl.cur = prev


def make_trace_ctx(name: str) -> dict | None:
    """Context dict injected into an outgoing task spec (None when
    tracing is off). An inherited active span counts as enabled, so
    workers propagate traces without flipping their own switch."""
    cur = _active()
    if not is_tracing_enabled() and cur is None:
        return None
    trace_id = cur[0] if cur else uuid.uuid4().hex[:16]
    return {
        "trace_id": trace_id,
        "parent_id": cur[1] if cur else "",
        "name": name,
    }


@contextlib.contextmanager
def activate(trace_ctx: dict | None):
    """Worker side: run the task under its inherited trace context and
    record the execution span. Yields the span_id (or None)."""
    if not trace_ctx:
        yield None
        return
    span_id = uuid.uuid4().hex[:16]
    token = _current.set((trace_ctx["trace_id"], span_id))
    start = time.time()
    try:
        yield span_id
    finally:
        _current.reset(token)
        record_span(
            trace_ctx["trace_id"],
            span_id,
            trace_ctx.get("parent_id", ""),
            trace_ctx.get("name", ""),
            start,
            time.time() - start,
        )


@contextlib.contextmanager
def span(name: str):
    """User-level span (works in drivers and inside tasks)."""
    if not is_tracing_enabled():
        yield
        return
    cur = _active()
    trace_id = cur[0] if cur else uuid.uuid4().hex[:16]
    span_id = uuid.uuid4().hex[:16]
    token = _current.set((trace_id, span_id))
    prev_tl = getattr(_tl, "cur", None)
    _tl.cur = (trace_id, span_id)
    start = time.time()
    try:
        yield
    finally:
        _current.reset(token)
        _tl.cur = prev_tl
        record_span(
            trace_id, span_id, cur[1] if cur else "", name, start,
            time.time() - start,
        )


@contextlib.contextmanager
def trace_scope(ctx: tuple[str, str] | None):
    """Install ``ctx`` as the active trace context for the body without
    recording a span of its own (the caller records one with explicit
    ids via record_span). Contextvar-based, so it is async-safe: set
    inside a coroutine it propagates through that task's awaits and
    cannot leak into concurrent tasks. A None ctx is a no-op."""
    if ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


@contextlib.contextmanager
def linked_span(name: str, parent: tuple[str, str] | None = None, **attrs):
    """Measure the body as a span parented under ``parent`` (or the
    active context), installing itself as active so nested spans chain.
    Ungated like emit_span — the serve request path calls it only when
    serve telemetry is on AND an upstream trace context exists, so the
    gating lives at the ingress, not here. Yields the span's
    (trace_id, span_id) so callers can ship it across process hops."""
    cur = parent if parent is not None else _active()
    trace_id = cur[0] if cur else uuid.uuid4().hex[:16]
    span_id = uuid.uuid4().hex[:16]
    token = _current.set((trace_id, span_id))
    start = time.time()
    try:
        yield (trace_id, span_id)
    finally:
        _current.reset(token)
        record_span(
            trace_id, span_id, cur[1] if cur else "", name, start,
            time.time() - start, **attrs,
        )


def record_span(trace_id, span_id, parent_id, name, start, dur, **attrs):
    """Spans ride the task-event buffer (flushed to the head like any
    task state transition, core_worker._flush_events_loop). Extra
    keyword attributes (bytes moved, phase breakdowns, train job) travel
    on the event and surface in the timeline's args."""
    try:
        import ray_tpu_torch.api as api

        core = api._runtime.core
    # tpulint: allow(broad-except reason=span recording must never fail the traced operation; without a runtime there is no event pipeline to record into, so dropping is the contract)
    except Exception:  # noqa: BLE001 - no runtime, drop the span
        return
    if core is None:
        return
    core.record_task_event(
        {"task_id": f"span:{span_id}", "name": name},
        "SPAN",
        trace_id=trace_id,
        span_id=span_id,
        parent_id=parent_id,
        ts=start,
        dur=dur,
        **attrs,
    )


def emit_span(name: str, start: float, dur: float, **attrs) -> None:
    """Record an externally measured, already-completed span, linked
    under the active trace context when one exists (fresh trace
    otherwise). Used by the collective flight recorder and train step
    telemetry; NOT gated on enable_tracing — these coarse spans are what
    make `ray_tpu_torch timeline` show collective ops and step phases without
    a tracing opt-in, and recording one is an in-memory list append."""
    cur = _active()
    trace_id = cur[0] if cur else uuid.uuid4().hex[:16]
    span_id = uuid.uuid4().hex[:16]
    record_span(
        trace_id, span_id, cur[1] if cur else "", name, start, dur, **attrs
    )


async def carry_context(coro, ctx: tuple[str, str]):
    """Await `coro` with `ctx` installed as its trace context. The
    collective dispatch layer hops from the caller's thread onto the
    runtime loop (run_coroutine_threadsafe does not propagate
    contextvars), so it captures the caller's active span and re-installs
    it inside the coroutine — spans the op emits (flight recorder) then
    parent under the task that issued the collective. Each asyncio task
    runs in its own Context copy, so the set/reset cannot leak into
    concurrent tasks."""
    token = _current.set(ctx)
    try:
        return await coro
    finally:
        _current.reset(token)


def get_trace_events(limit: int = 2000) -> list[dict]:
    """All spans the head has collected (driver-side query). The SPAN
    filter runs on the head BEFORE `limit` is applied, so busy task
    traffic cannot evict spans from the reply."""
    import ray_tpu_torch.api as api

    rt = api._runtime
    reply = rt.run(
        rt.core.head.call(
            "list_task_events", limit=limit, raw=True, state="SPAN"
        )
    )
    return [e for e in reply["events"] if e.get("state") == "SPAN"]


class ProfileCapture:
    """Handle yielded by torch_profile: `path` resolves to the session
    directory the profiler wrote (``<log_dir>/plugins/profile/<run>``)
    after the context exits, None when nothing was written; `profile` is
    the stopped ``torch.profiler.profile``, for reading its events
    (``_private/kernel_profile.py``)."""

    __slots__ = ("log_dir", "path", "profile")

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: str | None = None
        self.profile = None


def _resolve_capture_path(log_dir: str) -> str | None:
    """Newest run directory under <log_dir>/plugins/profile/ — where
    torch_profile writes its Chrome trace."""
    root = os.path.join(log_dir, "plugins", "profile")
    try:
        runs = [
            os.path.join(root, d)
            for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        ]
    except OSError:
        return None
    if not runs:
        return None
    return max(runs, key=os.path.getmtime)


@contextlib.contextmanager
def torch_profile(log_dir: str | None = None):
    """On-device profiling via ``torch.profiler``: CPU activity, and CUDA
    activity when the process has a card. The counterpart of the JAX
    package's ``jax_profile``.

    Yields a :class:`ProfileCapture` whose ``path`` is filled in after
    the body exits: the session directory
    ``<log_dir>/plugins/profile/<run>`` holding the Chrome trace
    (``<host>.<pid>.pt.trace.json``, for chrome://tracing or Perfetto).
    Emits a ``profile:capture`` span so captures are discoverable from
    ``timeline()``. ``log_dir`` defaults to ``RAY_TPU_PROFILE_DIR``
    (falling back to ``<tmpdir>/ray_tpu_torch_profile``) and is created
    if missing."""
    import socket
    import tempfile

    import torch

    from ray_tpu_torch._private import config

    if log_dir is None:
        log_dir = config.get("PROFILE_DIR") or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_profile"
        )
    os.makedirs(log_dir, exist_ok=True)
    cap = ProfileCapture(log_dir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    start = time.time()
    prof.start()
    try:
        yield cap
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the last step's kernels finish inside
        prof.stop()
        cap.profile = prof
        run = os.path.join(
            log_dir, "plugins", "profile",
            time.strftime("%Y_%m_%d_%H_%M_%S") + f"_{uuid.uuid4().hex[:6]}",
        )
        os.makedirs(run, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            run, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"
        ))
        cap.path = _resolve_capture_path(log_dir)
        emit_span(
            "profile:capture",
            start,
            time.time() - start,
            path=cap.path or log_dir,
        )
