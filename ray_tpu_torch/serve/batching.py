"""@serve.batch: dynamic request batching inside a replica.

(reference: python/ray/serve/batching.py — single-element calls queue up;
a flusher invokes the wrapped method with a list once max_batch_size is
reached or batch_wait_timeout_s elapses; the wrapped method returns a
list of per-element results.)

On TPU this is the tool that turns concurrent single requests into one
batched forward pass (MXU wants large batches).
"""

from __future__ import annotations

import asyncio
import functools
import inspect


class _BatchQueue:
    def __init__(self, fn, self_arg, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._self_arg = self_arg
        self._max = max_batch_size
        self._timeout = timeout_s
        self._pending: list[tuple] = []  # (arg, future)
        self._flusher: asyncio.Task | None = None
        # Telemetry label: the deployment this queue batches for when
        # known (first submit runs under the request context), else the
        # wrapped function's name — bounded either way.
        self._label = getattr(fn, "__qualname__", "batch")

    async def submit(self, arg):
        from ray_tpu_torch.serve import telemetry as stel
        from ray_tpu_torch.serve.context import get_request_context

        dep = get_request_context().deployment
        if dep:
            self._label = dep
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((arg, fut))
        if stel.enabled():
            stel.BATCH_OCCUPANCY.set(
                len(self._pending) / max(1, self._max),
                tags={"deployment": self._label},
            )
        if len(self._pending) >= self._max:
            self._flush_now()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._delayed_flush())
        return await fut

    async def _delayed_flush(self):
        await asyncio.sleep(self._timeout)
        self._flush_now()

    def _flush_now(self):
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        if self._flusher is not None and not self._flusher.done():
            self._flusher.cancel()
        self._flusher = None
        asyncio.ensure_future(self._run_batch(batch))

    async def _run_batch(self, batch: list[tuple]):
        import time

        from ray_tpu_torch.serve import telemetry as stel

        args = [a for a, _ in batch]
        start = time.time()
        try:
            if self._self_arg is not None:
                results = self._fn(self._self_arg, args)
            else:
                results = self._fn(args)
            if inspect.isawaitable(results):
                results = await results
            if len(results) != len(args):
                raise ValueError(
                    f"batched function returned {len(results)} results "
                    f"for a batch of {len(args)}"
                )
            for (_, fut), r in zip(batch, results):
                if not fut.done():
                    fut.set_result(r)
            if stel.enabled():
                # One sampled span per flush: occupancy + wait are the
                # signals that tune max_batch_size/batch_wait_timeout_s.
                from ray_tpu_torch.collective import flight_recorder
                from ray_tpu_torch.util import tracing

                dur = time.time() - start
                emit, n = flight_recorder.span_sample(
                    self._label, "serve:batch", dur
                )
                if emit:
                    attrs = {
                        "deployment": self._label,
                        "batch_size": len(batch),
                        "occupancy": round(len(batch) / max(1, self._max), 3),
                    }
                    if n > 1:
                        attrs["sample_rate"] = n
                    tracing.emit_span("serve:batch", start, dur, **attrs)
        # tpulint: allow(broad-except reason=the batch failure is fanned out to every caller's future - nothing is swallowed)
        except Exception as e:  # noqa: BLE001 - fan the error out
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 10, batch_wait_timeout_s: float = 0.01):
    """Decorator for methods/functions taking a list of items.

    The decorated callable is invoked with single items; the underlying
    implementation receives a list and returns a same-length list.
    """

    def deco(fn):
        attr = f"__serve_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def method_wrapper(self, arg):
            q = getattr(self, attr, None)
            if q is None:
                q = _BatchQueue(fn, self, max_batch_size, batch_wait_timeout_s)
                setattr(self, attr, q)
            return await q.submit(arg)

        @functools.wraps(fn)
        async def func_wrapper(arg):
            q = func_wrapper.__dict__.get("_queue")
            if q is None:
                q = _BatchQueue(fn, None, max_batch_size, batch_wait_timeout_s)
                func_wrapper._queue = q
            return await q.submit(arg)

        params = list(inspect.signature(fn).parameters)
        return method_wrapper if params and params[0] == "self" else func_wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
