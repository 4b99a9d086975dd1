"""DeploymentHandle: the client-side router to a deployment's replicas.

(reference: python/ray/serve/handle.py:757 DeploymentHandle →
_private/router.py AsyncioRouter with power-of-two-choices replica
picking over queue-length caps, request_router/; replica membership is
pushed by long-poll in the reference — here the router polls the
controller's versioned replica list and refreshes on miss/death.)

All routing state lives on the runtime event loop, so in-flight counts
need no locks. ``remote()`` works from sync code (driver threads, the
HTTP proxy) and from async code running on the runtime loop (other
replicas, the controller).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import uuid
import zlib
from dataclasses import dataclass

from ray_tpu_torch import api as core_api
from ray_tpu_torch.runtime.core_worker import ActorSubmitTarget

logger = logging.getLogger("ray_tpu_torch.serve")

CONTROLLER_NAME = "_SERVE_CONTROLLER"
_REFRESH_S = 2.0


@dataclass
class _ReplicaTarget:
    actor_id: str
    addr: str
    max_ongoing: int


class _Breaker:
    """Per-replica circuit breaker (router-side). CLOSED routes
    normally; SERVE_BREAKER_FAILURES consecutive typed failures OPEN it
    (the replica is skipped by ``_pick``); after SERVE_BREAKER_RESET_S
    it goes HALF-OPEN and admits exactly one probe request — success
    CLOSES it, failure re-OPENS it. All state lives on the runtime
    event loop, like the rest of the router."""

    __slots__ = ("failures", "opened_at", "probing")

    def __init__(self):
        self.failures = 0
        self.opened_at: float | None = None
        self.probing = False

    def state(self, now: float, reset_s: float) -> str:
        if self.opened_at is None:
            return "closed"
        if now - self.opened_at >= reset_s:
            return "half_open"
        return "open"

    def allow(self, now: float, reset_s: float) -> bool:
        """May a request be dispatched to this replica right now?
        Half-open admits a single in-flight probe."""
        st = self.state(now, reset_s)
        if st == "closed":
            return True
        if st == "open":
            return False
        if self.probing:
            return False
        self.probing = True
        return True

    def routable(self, now: float, reset_s: float) -> bool:
        """Pure check (no probe consumed) for the router's
        no-replica-available clock: an open breaker that has not yet
        reached half-open is the only unroutable state."""
        return self.state(now, reset_s) != "open"

    def record_failure(self, now: float, threshold: int) -> None:
        self.failures += 1
        self.probing = False
        if self.opened_at is not None:
            self.opened_at = now  # half-open probe failed: re-open
        elif self.failures >= threshold:
            self.opened_at = now  # closed → open

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None
        self.probing = False


class DeploymentResponse:
    """Future-like result of a handle call (reference: handle.py
    DeploymentResponse). ``result()`` from sync code; ``await`` from
    async code on the runtime loop."""

    def __init__(self, inner, sync: bool):
        self._inner = inner  # concurrent.futures.Future | asyncio.Task
        self._sync = sync

    def result(self, timeout: float | None = None):
        if not self._sync:
            raise RuntimeError(
                "result() would deadlock on the runtime loop; use "
                "`await response` in async code"
            )
        return self._inner.result(timeout)

    def __await__(self):
        if self._sync:
            # Bridge a concurrent future into the awaiting loop.
            return asyncio.wrap_future(self._inner).__await__()
        return self._inner.__await__()


class DeploymentStreamResponse:
    """Iterator over a streaming handle call's yields (reference:
    handle.py DeploymentResponseGenerator). Async-iterate on the runtime
    loop (proxy, composed replicas); sync-iterate from driver threads.
    Items arrive incrementally as the replica yields them."""

    def __init__(self, agen, sync: bool):
        self._agen = agen
        self._sync = sync

    def __aiter__(self):
        if not self._sync:
            return self._agen

        # Foreign event loop (sync=True means the caller is NOT on the
        # runtime loop): drive the router generator on the runtime loop
        # and bridge each item — iterating it directly would attach rpc
        # futures to the wrong loop.
        async def bridge():
            while True:
                fut = asyncio.run_coroutine_threadsafe(
                    self._agen.__anext__(), core_api._runtime.loop
                )
                try:
                    item = await asyncio.wrap_future(fut)
                except StopAsyncIteration:
                    return
                yield item

        return bridge()

    def __iter__(self):
        if not self._sync:
            raise RuntimeError(
                "sync iteration would deadlock on the runtime loop; use "
                "`async for` in async code"
            )
        return self

    def __next__(self):
        fut = asyncio.run_coroutine_threadsafe(
            self._agen.__anext__(), core_api._runtime.loop
        )
        try:
            return fut.result()
        except StopAsyncIteration:
            raise StopIteration from None

    def close(self):
        """Stop consuming; the replica-side generator is told to stop."""
        if self._sync:
            asyncio.run_coroutine_threadsafe(
                self._agen.aclose(), core_api._runtime.loop
            ).result(timeout=5)
        else:
            asyncio.ensure_future(self._agen.aclose())


def _is_draining_refusal(e: Exception) -> bool:
    """Did a replica refuse the request because it is draining? The
    typed error arrives either directly or wrapped in RayTaskError
    (with the original in .cause, or stringified when the cause could
    not travel)."""
    from ray_tpu_torch.exceptions import RayTaskError, ReplicaDrainingError

    if isinstance(e, ReplicaDrainingError):
        return True
    if isinstance(e, RayTaskError):
        return isinstance(
            getattr(e, "cause", None), ReplicaDrainingError
        ) or "ReplicaDrainingError" in str(e)
    return False


class _Router:
    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._controller: ActorSubmitTarget | None = None
        self._replicas: list[_ReplicaTarget] = []
        self._version = -1
        self._last_refresh = 0.0
        self._inflight: dict[str, int] = {}
        # Requests waiting for a replica slot; reported to the controller
        # as autoscaling demand (reference: handles push queued-request
        # metrics to the controller, serve/_private/router.py).
        self._queued = 0
        self._reporter: asyncio.Task | None = None
        # Stable across the router's life, unique across processes (id()
        # values repeat across address spaces and would alias demand
        # reports at the controller).
        self._router_id = uuid.uuid4().hex
        # model_id → (version, replicas ordered by affinity hash); the
        # order only changes when the replica set does.
        self._affinity: dict[str, tuple[int, list[_ReplicaTarget]]] = {}
        # actor_id → circuit breaker. Keyed by actor id (not list
        # position) so a dead replica the controller still lists for a
        # few missed polls stays skipped across refreshes.
        self._breakers: dict[str, _Breaker] = {}
        # Serializes the controller get_replicas RPC: N queued requests
        # forcing refreshes at once must produce ONE poll, not N
        # (instrumented under RAY_TPU_SANITIZE=1).
        from ray_tpu_torch._private import sanitize

        self._refresh_lock = sanitize.maybe_async_lock(
            "serve.handle.refresh"
        )

    def _demand(self) -> int:
        return self._queued + sum(self._inflight.values())

    def _ensure_reporter(self):
        if self._reporter is None or self._reporter.done():
            self._reporter = asyncio.ensure_future(self._report_loop())

    async def _report_loop(self):
        """Report demand while there is any; exit after a short idle
        period (a final 0 report) so dropped handles don't leak an
        eternal task + RPC stream."""
        from ray_tpu_torch.serve import telemetry as stel

        router_id = self._router_id
        idle_since = None
        tel_on = stel.enabled()
        try:
            while True:
                demand = self._demand()
                if tel_on:
                    # Same cadence as the autoscaling demand report: the
                    # queue-depth gauge IS that signal, scrapeable.
                    stel.QUEUE_DEPTH.set(
                        demand,
                        tags={"app": self.app_name,
                              "deployment": self.deployment_name},
                    )
                controller = await self._resolve_controller()
                await self._call_actor(
                    controller,
                    "record_handle_demand",
                    self.deployment_name,
                    self.app_name,
                    router_id,
                    demand,
                )
                if demand == 0:
                    if idle_since is None:
                        idle_since = time.monotonic()
                    elif time.monotonic() - idle_since > 3.0:
                        return
                else:
                    idle_since = None
                await asyncio.sleep(0.3)
        except Exception:  # noqa: BLE001 - controller gone; stop quietly
            logger.debug(
                "handle demand reporter for %s/%s stopped "
                "(controller unreachable)",
                self.app_name, self.deployment_name, exc_info=True,
            )

    async def _core(self):
        core = core_api._runtime.core
        if core is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        return core

    async def _resolve_controller(self):
        if self._controller is None:
            core = await self._core()
            reply = await core.head.call("get_actor", name=CONTROLLER_NAME)
            if not reply["ok"]:
                raise RuntimeError(
                    "serve controller is not running (serve.run first)"
                )
            self._controller = ActorSubmitTarget(
                reply["actor_id"], reply["addr"]
            )
        return self._controller

    async def _call_actor(self, target: ActorSubmitTarget, method, *args):
        core = await self._core()
        refs = await core.submit_task(
            method, args, {}, num_returns=1, actor=target
        )
        values = await core.get(refs)
        return values[0]

    async def _refresh(self, force: bool = False):
        # Forced refreshes (saturation, replica death) are still rate
        # limited so N queued requests don't hammer the controller with
        # N/20ms get_replicas calls exactly when the system is loaded.
        min_interval = 0.1 if force else _REFRESH_S
        if time.monotonic() - self._last_refresh < min_interval:
            return
        async with self._refresh_lock:
            # Re-check under the lock: the poll a concurrent waiter just
            # finished IS this waiter's refresh.
            if time.monotonic() - self._last_refresh < min_interval:
                return
            controller = await self._resolve_controller()
            version, replicas = await self._call_actor(
                controller, "get_replicas", self.deployment_name,
                self.app_name,
            )
            self._last_refresh = time.monotonic()
            if version != self._version:
                self._version = version
                self._replicas = [_ReplicaTarget(*r) for r in replicas]
                self._inflight = {
                    r.actor_id: self._inflight.get(r.actor_id, 0)
                    for r in self._replicas
                }
                # Orderings cached against the old replica set are dead
                # weight now; dropping the whole map also bounds its
                # growth across high-cardinality model ids.
                self._affinity.clear()
                # Breakers for replicas the controller no longer lists
                # are dead weight too — but entries for still-listed
                # replicas survive (a dead replica stays listed for a
                # few missed polls; its open breaker is what keeps it
                # skipped meanwhile).
                listed = {r.actor_id for r in self._replicas}
                for aid in list(self._breakers):
                    if aid not in listed:
                        del self._breakers[aid]

    def _breaker_allows(self, actor_id: str, now: float,
                        reset_s: float) -> bool:
        """Pure pick-eligibility: open → no; half-open with a probe
        already in flight → no. The probe itself is consumed only for
        the replica ``_pick`` actually returns (``_consume_probe``)."""
        br = self._breakers.get(actor_id)
        if br is None:
            return True
        st = br.state(now, reset_s)
        return st == "closed" or (st == "half_open" and not br.probing)

    def _consume_probe(self, replica: _ReplicaTarget, now: float,
                       reset_s: float) -> _ReplicaTarget:
        br = self._breakers.get(replica.actor_id)
        if br is not None:
            br.allow(now, reset_s)  # half-open: claims the single probe
        return replica

    def _has_routable(self) -> bool:
        """Any replica a request could EVER land on right now —
        saturation (in-flight at cap) still counts as routable (the
        request queues), only dead/open-breaker replicas don't. The
        guard deciding whether a slot wait is queueing or an outage."""
        if not self._replicas:
            return False
        from ray_tpu_torch._private import config

        now = time.monotonic()
        reset_s = config.get("SERVE_BREAKER_RESET_S")
        return any(
            br is None or br.routable(now, reset_s)
            for br in (
                self._breakers.get(r.actor_id) for r in self._replicas
            )
        )

    def _record_replica_failure(self, actor_id: str):
        from ray_tpu_torch._private import config

        br = self._breakers.setdefault(actor_id, _Breaker())
        br.record_failure(
            time.monotonic(), config.get("SERVE_BREAKER_FAILURES")
        )
        self._update_breaker_gauge()

    def _record_replica_success(self, actor_id: str):
        br = self._breakers.get(actor_id)
        if br is not None and (br.opened_at is not None or br.failures):
            br.record_success()
            self._update_breaker_gauge()

    def _update_breaker_gauge(self):
        from ray_tpu_torch.serve import telemetry as stel

        if not stel.enabled():
            return
        stel.BREAKER_OPEN.set(
            sum(
                1 for br in self._breakers.values()
                if br.opened_at is not None
            ),
            tags={"app": self.app_name,
                  "deployment": self.deployment_name},
        )

    @staticmethod
    def _is_replica_death(e: Exception) -> bool:
        """Typed replica-death detection: the actor's worker is gone or
        its connection dropped mid-call. User exceptions (RayTaskError)
        are NOT deaths — they propagate to the caller untouched."""
        from ray_tpu_torch.exceptions import ActorDiedError
        from ray_tpu_torch._private import rpc

        return isinstance(
            e, (ActorDiedError, rpc.ConnectionLost, rpc.RpcError)
        )

    @staticmethod
    def _retry_max() -> int:
        from ray_tpu_torch._private import config

        return config.get("SERVE_RETRY_MAX")

    @staticmethod
    def _retry_backoff(attempt: int) -> float:
        """Exponential per-retry backoff, capped at 1s: the surviving
        replicas are absorbing the dead one's load exactly now — a
        stampede of instant retries is the last thing they need."""
        from ray_tpu_torch._private import config

        base = config.get("SERVE_RETRY_BACKOFF_S")
        return min(1.0, base * (2 ** max(0, attempt - 1)))

    def _count_retry(self, reason: str):
        from ray_tpu_torch.serve import telemetry as stel

        if stel.enabled():
            stel.RETRIES.inc(
                tags={"app": self.app_name,
                      "deployment": self.deployment_name,
                      "reason": reason},
            )

    def _count_death(self):
        from ray_tpu_torch.serve import telemetry as stel

        if stel.enabled():
            stel.REPLICA_DEATHS.inc(
                tags={"app": self.app_name,
                      "deployment": self.deployment_name},
            )

    def _drop_replica(self, actor_id: str):
        """Forget a replica ahead of the controller (typed death or
        draining refusal observed first-hand): stop picking it NOW; the
        next version bump reconciles the authoritative list."""
        self._replicas = [
            r for r in self._replicas if r.actor_id != actor_id
        ]
        # The controller may not bump the version for several missed
        # polls; cached affinity orderings still point at the dead
        # replica until then.
        self._affinity.clear()

    def _pick(self, model_id: str) -> _ReplicaTarget | None:
        from ray_tpu_torch._private import config

        now = time.monotonic()
        reset_s = config.get("SERVE_BREAKER_RESET_S")
        avail = [
            r
            for r in self._replicas
            if self._inflight.get(r.actor_id, 0) < r.max_ongoing
            and self._breaker_allows(r.actor_id, now, reset_s)
        ]
        if not avail:
            return None
        if model_id:
            # Hash-affinity for multiplexed models: keep a model's
            # requests on a stable replica so its LRU cache stays warm
            # (reference approximates this with cache-locality routing,
            # multiplex.py); spill down the ordering when saturated.
            # crc32, not hash(): PYTHONHASHSEED randomization would send
            # the same model to different replicas from different
            # processes, thrashing every replica's model LRU.
            if len(self._affinity) > 4096:  # hard cap per router
                self._affinity.clear()
            cached = self._affinity.get(model_id)
            if cached is None or cached[0] != self._version:
                ordered = sorted(
                    self._replicas,
                    key=lambda r: zlib.crc32(
                        f"{model_id}:{r.actor_id}".encode()
                    ),
                )
                self._affinity[model_id] = (self._version, ordered)
            else:
                ordered = cached[1]
            for r in ordered:
                if self._inflight.get(r.actor_id, 0) < r.max_ongoing \
                        and self._breaker_allows(r.actor_id, now, reset_s):
                    return self._consume_probe(r, now, reset_s)
            return None
        if len(avail) == 1:
            return self._consume_probe(avail[0], now, reset_s)
        a, b = random.sample(avail, 2)
        return self._consume_probe(
            a
            if self._inflight.get(a.actor_id, 0)
            <= self._inflight.get(b.actor_id, 0)
            else b,
            now, reset_s,
        )

    def _request_ctx(self, model_id: str) -> dict:
        """Per-call request context shipped to the replica. When serve
        telemetry is on and a trace context is active (a proxy ingress
        span, or any caller running under a span), it rides along so
        the replica's spans join the same tree."""
        ctx = {
            "request_id": uuid.uuid4().hex[:16],
            "multiplexed_model_id": model_id,
            "app_name": self.app_name,
            "deployment": self.deployment_name,
        }
        from ray_tpu_torch.serve import telemetry as stel

        if stel.enabled():
            from ray_tpu_torch.util import tracing

            active = tracing.active_context()
            if active is not None:
                ctx["trace"] = list(active)
        return ctx

    async def _acquire_replica_traced(self, model_id: str) -> _ReplicaTarget:
        """_acquire_replica plus a ``serve:queue`` span covering the
        wait for a replica slot — the queueing phase of the request
        span tree (sampled under storm, see telemetry.record_queue_wait)."""
        from ray_tpu_torch.serve import telemetry as stel

        if not stel.enabled():
            return await self._acquire_replica(model_id)
        q_start = time.time()
        replica = await self._acquire_replica(model_id)
        stel.record_queue_wait(
            self.app_name, self.deployment_name, q_start,
            time.time() - q_start,
        )
        return replica

    async def _acquire_replica(self, model_id: str) -> _ReplicaTarget:
        """Wait for a replica slot. Saturated-but-alive replicas queue
        indefinitely (backpressure, reported as autoscaling demand);
        NO routable replica at all — none known, or every one dead,
        draining, or breaker-open — for SERVE_UNAVAILABLE_TIMEOUT_S
        raises the typed NoReplicaAvailableError instead of hanging
        (the proxy's 503 + Retry-After)."""
        from ray_tpu_torch._private import config

        waiting = False
        unroutable_since: float | None = None
        try:
            while True:
                await self._refresh()
                replica = self._pick(model_id)
                if replica is not None:
                    return replica
                if self._has_routable():
                    unroutable_since = None
                else:
                    now = time.monotonic()
                    if unroutable_since is None:
                        unroutable_since = now
                    bound = config.get("SERVE_UNAVAILABLE_TIMEOUT_S")
                    if now - unroutable_since >= bound:
                        from ray_tpu_torch.exceptions import (
                            NoReplicaAvailableError,
                        )

                        raise NoReplicaAvailableError(
                            self.deployment_name,
                            self.app_name,
                            retry_after_s=max(
                                1.0,
                                config.get("SERVE_BREAKER_RESET_S"),
                            ),
                        )
                if not waiting:
                    waiting = True
                    self._queued += 1
                await self._refresh(force=True)
                await asyncio.sleep(0.02)
        finally:
            if waiting:
                self._queued -= 1

    async def route_and_call(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        model_id: str = "",
        retry_on_failure: bool = True,
    ):
        # Resolve composed-handle responses passed as arguments.
        args = tuple(
            [await a if isinstance(a, DeploymentResponse) else a for a in args]
        )
        kwargs = {
            k: (await v if isinstance(v, DeploymentResponse) else v)
            for k, v in kwargs.items()
        }
        ctx = self._request_ctx(model_id)
        self._ensure_reporter()
        deaths = 0
        drain_hops = 0
        while True:
            replica = await self._acquire_replica_traced(model_id)
            self._inflight[replica.actor_id] = (
                self._inflight.get(replica.actor_id, 0) + 1
            )
            try:
                result = await self._call_actor(
                    ActorSubmitTarget(replica.actor_id, replica.addr),
                    "handle_request",
                    method_name,
                    args,
                    kwargs,
                    ctx,
                )
                self._record_replica_success(replica.actor_id)
                return result
            except Exception as e:  # noqa: BLE001
                if _is_draining_refusal(e):
                    # The replica is retiring (scale-down drain) and
                    # REFUSED the request before starting it — always
                    # safe to re-dispatch, even for non-idempotent
                    # calls, and it never burns a death retry. Bounded
                    # anyway: an entire replica set draining at once
                    # must end in NoReplicaAvailableError, not a spin.
                    drain_hops += 1
                    if drain_hops <= 10:
                        self._drop_replica(replica.actor_id)
                        self._count_retry("draining")
                        await self._refresh(force=True)
                        continue
                    raise
                if self._is_replica_death(e):
                    # Replica died mid-request: open/advance its
                    # breaker, drop it, and re-route with backoff.
                    # NOTE: at-least-once — the dead replica may
                    # already have executed the request. Non-idempotent
                    # callers opt out via
                    # .options(retry_on_failure=False).
                    self._record_replica_failure(replica.actor_id)
                    self._count_death()
                    if retry_on_failure and deaths < self._retry_max():
                        deaths += 1
                        self._drop_replica(replica.actor_id)
                        self._count_retry("death")
                        await asyncio.sleep(self._retry_backoff(deaths))
                        await self._refresh(force=True)
                        continue
                raise
            finally:
                if replica.actor_id in self._inflight:
                    self._inflight[replica.actor_id] -= 1


    async def stream_call(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        model_id: str = "",
        retry_on_failure: bool = True,
    ):
        """Async generator: route to a replica and yield the streaming
        actor call's items as they arrive (reference: streaming handle
        calls, serve/handle.py `handle.options(stream=True)`). Re-routes
        on replica death only before the first item has been yielded."""
        args = tuple(
            [await a if isinstance(a, DeploymentResponse) else a for a in args]
        )
        kwargs = {
            k: (await v if isinstance(v, DeploymentResponse) else v)
            for k, v in kwargs.items()
        }
        ctx = self._request_ctx(model_id)
        self._ensure_reporter()
        core = await self._core()
        deaths = 0
        drain_hops = 0
        while True:
            replica = await self._acquire_replica_traced(model_id)
            self._inflight[replica.actor_id] = (
                self._inflight.get(replica.actor_id, 0) + 1
            )
            yielded = False
            try:
                task_id = await core.submit_task(
                    "handle_request_streaming",
                    (method_name, args, kwargs, ctx),
                    {},
                    num_returns="streaming",
                    actor=ActorSubmitTarget(replica.actor_id, replica.addr),
                )
                try:
                    while True:
                        entry = await core.next_generator_item(task_id)
                        if entry[0] == "done":
                            self._record_replica_success(replica.actor_id)
                            return
                        if entry[0] == "error":
                            raise entry[1]
                        value = (
                            await core.get(
                                [core_api.ObjectRef(entry[1], core.addr)]
                            )
                        )[0]
                        yielded = True
                        yield value
                finally:
                    # Consumer broke out early (or terminal entry already
                    # cleaned up — then this is a no-op): abandon the
                    # stream so the replica stops producing.
                    await core.close_generator(task_id)
            except GeneratorExit:
                raise
            except Exception as e:  # noqa: BLE001
                if not yielded and _is_draining_refusal(e):
                    # Retiring replica refused before starting the
                    # stream: always re-routable (see route_and_call).
                    drain_hops += 1
                    if drain_hops <= 10:
                        self._drop_replica(replica.actor_id)
                        self._count_retry("draining")
                        await self._refresh(force=True)
                        continue
                    raise
                if self._is_replica_death(e):
                    self._record_replica_failure(replica.actor_id)
                    self._count_death()
                    # Re-route only before the first yield: a consumer
                    # that already saw items cannot be transparently
                    # replayed — it gets the TYPED death (fail fast,
                    # never a hang) and decides about a fresh request.
                    if (
                        retry_on_failure
                        and not yielded
                        and deaths < self._retry_max()
                    ):
                        deaths += 1
                        self._drop_replica(replica.actor_id)
                        self._count_retry("death")
                        await asyncio.sleep(self._retry_backoff(deaths))
                        await self._refresh(force=True)
                        continue
                raise
            finally:
                if replica.actor_id in self._inflight:
                    self._inflight[replica.actor_id] -= 1


class DeploymentHandle:
    """Serializable, lazy handle: resolves the controller and replica
    set on first call, so it can be shipped into replicas for model
    composition (reference: handles injected for `.bind()` children)."""

    def __init__(
        self,
        deployment_name: str,
        app_name: str = "default",
        method_name: str = "__call__",
        multiplexed_model_id: str = "",
        retry_on_failure: bool = True,
        stream: bool = False,
    ):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._model_id = multiplexed_model_id
        self._retry = retry_on_failure
        self._stream = stream
        self._router: _Router | None = None

    def __reduce__(self):
        return (
            DeploymentHandle,
            (
                self.deployment_name,
                self.app_name,
                self._method_name,
                self._model_id,
                self._retry,
                self._stream,
            ),
        )

    def options(
        self,
        *,
        method_name: str | None = None,
        multiplexed_model_id: str | None = None,
        retry_on_failure: bool | None = None,
        stream: bool | None = None,
    ) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.deployment_name,
            self.app_name,
            method_name or self._method_name,
            self._model_id
            if multiplexed_model_id is None
            else multiplexed_model_id,
            self._retry if retry_on_failure is None else retry_on_failure,
            self._stream if stream is None else stream,
        )
        h._router = self._router  # share routing state across options()
        return h

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def _get_router(self) -> _Router:
        if self._router is None:
            self._router = _Router(self.deployment_name, self.app_name)
        return self._router

    def remote(self, *args, **kwargs):
        router = self._get_router()
        loop = core_api._runtime.loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if self._stream:
            agen = router.stream_call(
                self._method_name, args, kwargs, self._model_id, self._retry
            )
            return DeploymentStreamResponse(agen, sync=running is not loop)
        coro = router.route_and_call(
            self._method_name, args, kwargs, self._model_id, self._retry
        )
        if running is loop:
            return DeploymentResponse(asyncio.ensure_future(coro), sync=False)
        fut = asyncio.run_coroutine_threadsafe(coro, loop)
        return DeploymentResponse(fut, sync=True)

    def __repr__(self):
        return (
            f"DeploymentHandle({self.app_name}/{self.deployment_name}"
            f".{self._method_name})"
        )
