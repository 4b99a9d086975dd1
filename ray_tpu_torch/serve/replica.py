"""Replica actor: hosts one copy of the user's deployment callable.

(reference: python/ray/serve/_private/replica.py:1139 `Replica` — wraps
the user callable, tracks ongoing requests for autoscaling stats, applies
user_config reconfiguration.)

Requests arrive as concurrent async actor calls (``handle_request`` is a
coroutine, so the core worker runs them out-of-order under
max_concurrency) — the replica itself enforces no queue; admission is the
router's job via in-flight caps.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import inspect

from ray_tpu_torch.serve.context import RequestContext, set_request_context


def _replica_scope(deployment_name: str, request_context: dict | None):
    """Span scope for one replica call: when the router shipped a trace
    context (serve telemetry on, ingress span upstream), run the user
    code under a ``serve:replica`` span parented to it — engine spans
    emitted inside (prefill/decode) then chain under this replica span.
    Returns (scope_cm, context_kwargs): the kwargs are the RequestContext
    fields with the transport-only "trace" key stripped."""
    ctx = dict(request_context or {})
    trace = ctx.pop("trace", None)
    if not trace:
        return contextlib.nullcontext(), ctx
    from ray_tpu_torch.util import tracing

    return (
        tracing.linked_span(
            "serve:replica",
            parent=(trace[0], trace[1]),
            deployment=deployment_name,
            app=ctx.get("app_name", ""),
            request_id=ctx.get("request_id", ""),
        ),
        ctx,
    )


class ReplicaActor:
    def __init__(
        self,
        deployment_name: str,
        user_callable,  # class or function (cloudpickled by the runtime)
        init_args: tuple,
        init_kwargs: dict,
        user_config=None,
    ):
        self.deployment_name = deployment_name
        self._num_ongoing = 0
        self._num_served = 0
        self._draining = False
        if isinstance(user_callable, type):
            self._callable = user_callable(*init_args, **init_kwargs)
        else:
            self._callable = user_callable
        if user_config is not None:
            self._reconfigure(user_config)

    def _reconfigure(self, user_config):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is None:
            raise ValueError(
                f"deployment {self.deployment_name} got user_config but "
                "defines no reconfigure() method"
            )
        fn(user_config)

    def reconfigure(self, user_config):
        self._reconfigure(user_config)
        return True

    def prepare_drain(self) -> int:
        """Scale-down retirement, step 1 (controller-driven): stop
        accepting new requests, keep serving in-flight ones. Returns
        the in-flight count so the controller can kill immediately when
        the replica is already idle. Idempotent."""
        self._draining = True
        return self._num_ongoing

    def _check_draining(self):
        """Admission gate: a draining replica refuses NEW requests with
        the typed error the router re-routes on. Routers holding a
        replica list from before the scale-down version bump race this
        window — the typed refusal (instead of a served request) is
        what makes the drain a hard barrier."""
        if self._draining:
            from ray_tpu_torch.exceptions import ReplicaDrainingError

            raise ReplicaDrainingError(self.deployment_name)

    async def handle_request(
        self,
        method_name: str,
        request_args: tuple,
        request_kwargs: dict,
        request_context: dict | None = None,
    ):
        self._check_draining()
        self._num_ongoing += 1
        scope, ctx_kwargs = _replica_scope(
            self.deployment_name, request_context
        )
        try:
            with scope:
                set_request_context(RequestContext(**ctx_kwargs))
                if inspect.isfunction(self._callable):
                    fn = self._callable  # function deployment
                else:
                    fn = getattr(self._callable, method_name)
                if inspect.iscoroutinefunction(fn):
                    return await fn(*request_args, **request_kwargs)
                # Run sync user code off the event loop, propagating the
                # request contextvars into the executor thread.
                ctx = contextvars.copy_context()
                loop = asyncio.get_running_loop()
                return await loop.run_in_executor(
                    None,
                    lambda: ctx.run(fn, *request_args, **request_kwargs),
                )
        finally:
            self._num_ongoing -= 1
            self._num_served += 1

    async def handle_request_streaming(
        self,
        method_name: str,
        request_args: tuple,
        request_kwargs: dict,
        request_context: dict | None = None,
    ):
        """Streaming twin of handle_request (reference: replica.py
        `handle_request_streaming` — user generators stream through
        ObjectRefGenerator). Yields the user method's items as they are
        produced; a non-generator result yields exactly once, so the
        router can use one call shape for both."""
        self._check_draining()
        self._num_ongoing += 1
        scope, ctx_kwargs = _replica_scope(
            self.deployment_name, request_context
        )
        try:
            with scope:
                set_request_context(RequestContext(**ctx_kwargs))
                if inspect.isfunction(self._callable):
                    fn = self._callable
                else:
                    fn = getattr(self._callable, method_name)
                if inspect.isasyncgenfunction(fn):
                    result = fn(*request_args, **request_kwargs)
                elif inspect.iscoroutinefunction(fn):
                    result = await fn(*request_args, **request_kwargs)
                else:
                    ctx = contextvars.copy_context()
                    loop = asyncio.get_running_loop()
                    result = await loop.run_in_executor(
                        None,
                        lambda: ctx.run(fn, *request_args, **request_kwargs),
                    )
                if inspect.isasyncgen(result):
                    async for item in result:
                        yield item
                elif inspect.isgenerator(result):
                    # Drive sync generators off-loop so user compute
                    # between yields doesn't stall this replica's other
                    # requests.
                    loop = asyncio.get_running_loop()
                    _done = object()
                    while True:
                        item = await loop.run_in_executor(
                            None, lambda: next(result, _done)
                        )
                        if item is _done:
                            break
                        yield item
                else:
                    yield result
        finally:
            self._num_ongoing -= 1
            self._num_served += 1

    def get_stats(self) -> dict:
        import os

        return {
            "num_ongoing_requests": self._num_ongoing,
            "num_served": self._num_served,
            "draining": self._draining,
            # The hosting worker's pid: the deterministic handle the
            # replica-SIGKILL chaos path (test_utils.kill_one_replica)
            # and bench_serve's kill leg grab a victim by.
            "pid": os.getpid(),
        }

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True
