"""Serve request-path telemetry: trace minting, request spans, SLO
histograms, and saturation gauges.

The signal plane for the production-serve arc (ROADMAP): a trace
context is minted at proxy ingress (or adopted from an inbound
``traceparent`` / ``x-request-id`` header) and propagated through
handle dispatch → replica → LLM engine, emitting a connected span tree
per request — ``serve:ingress`` / ``serve:queue`` / ``serve:replica``
/ ``serve:prefill`` / ``serve:decode`` — on the same task-event
pipeline the train spans ride. Rank-0-analogue: the head folds
``serve:ingress`` spans into a per-deployment SLO ledger
(HeadService._serve_request_event) the way it folds ``train:step``
spans into goodput.

Metric labels stay BOUNDED (deployment/app/outcome — never request or
session ids; tpulint TPU403 enforces this); per-request identity rides
on span attributes instead, where cardinality is ring-bounded.

Disable with RAY_TPU_SERVE_TELEMETRY=0: ``begin_request`` then hands
back a shared no-op whose per-request overhead a perf-floor test pins
(tests/test_observability.py), mirroring the train step-telemetry
floor.
"""

from __future__ import annotations

import time
import uuid

from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

_LAT_BOUNDS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 120.0,
)
_TPOT_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)

REQUEST_LATENCY = Histogram(
    "ray_tpu_serve_request_latency_seconds",
    "end-to-end serve request latency at the proxy (ingress to last "
    "byte)",
    boundaries=_LAT_BOUNDS,
    tag_keys=("app", "deployment"),
)
TTFT = Histogram(
    "ray_tpu_serve_ttft_seconds",
    "time to first token/byte at the proxy (for unary requests this "
    "equals the request latency)",
    boundaries=_LAT_BOUNDS,
    tag_keys=("app", "deployment"),
)
TPOT = Histogram(
    "ray_tpu_serve_tpot_seconds",
    "per-output-token time of finished LLM requests (decode seconds / "
    "generated tokens)",
    boundaries=_TPOT_BOUNDS,
    tag_keys=("deployment",),
)
REQUESTS = Counter(
    "ray_tpu_serve_requests_total",
    "serve requests by outcome (ok / error / timeout)",
    tag_keys=("app", "deployment", "outcome"),
)
QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_queue_depth",
    "requests queued or in flight at this handle's router (the "
    "autoscaling demand signal)",
    tag_keys=("app", "deployment"),
)
TARGET_REPLICAS = Gauge(
    "ray_tpu_serve_target_replicas",
    "the controller's current target replica count per deployment (the "
    "autoscaler's output signal)",
    tag_keys=("app", "deployment"),
)
REPLICA_DEATHS = Counter(
    "ray_tpu_serve_replica_deaths_total",
    "typed replica deaths observed by handle routers (the request was "
    "re-dispatched unless retries were exhausted or opted out)",
    tag_keys=("app", "deployment"),
)
RETRIES = Counter(
    "ray_tpu_serve_retries_total",
    "handle-router request re-dispatches after a typed replica "
    "death or draining refusal",
    tag_keys=("app", "deployment", "reason"),
)
BREAKER_OPEN = Gauge(
    "ray_tpu_serve_breaker_open_replicas",
    "replicas this handle router currently holds an OPEN circuit "
    "breaker for (skipped by routing until half-open probes succeed)",
    tag_keys=("app", "deployment"),
)
DRAINED_REPLICAS = Counter(
    "ray_tpu_serve_drained_replicas_total",
    "replicas retired through the scale-down drain protocol, by how "
    "the drain ended (clean = in-flight hit zero, timeout = "
    "SERVE_DRAIN_TIMEOUT_S expired, dead = died mid-drain)",
    tag_keys=("app", "deployment", "outcome"),
)
BATCH_OCCUPANCY = Gauge(
    "ray_tpu_serve_batch_occupancy",
    "occupied fraction of the most recent batch (engine decode slots "
    "or @serve.batch flush)",
    tag_keys=("deployment",),
)
KV_CACHE_UTIL = Gauge(
    "ray_tpu_serve_kv_cache_utilization",
    "occupied fraction of the LLM engine's paged KV pool",
    tag_keys=("deployment",),
)


def enabled() -> bool:
    from ray_tpu_torch._private import config

    return config.get("SERVE_TELEMETRY")


def adopt_or_mint(headers: dict) -> tuple[str, str, str]:
    """(trace_id, ingress_span_id, request_id) for one proxy request.

    An inbound W3C ``traceparent`` (00-<32hex>-<16hex>-..) contributes
    its trace id; else ``x-request-id`` seeds both the request id and a
    derived trace id so retries of the same id land in the same trace;
    else both are minted fresh."""
    trace_id = ""
    request_id = (headers.get("x-request-id") or "").strip()[:128]
    tp = (headers.get("traceparent") or "").strip()
    parts = tp.split("-")
    if len(parts) >= 3 and len(parts[1]) == 32:
        try:
            int(parts[1], 16)
            trace_id = parts[1]
        except ValueError:
            pass
    if not trace_id:
        trace_id = (
            uuid.uuid5(uuid.NAMESPACE_URL, request_id).hex[:16]
            if request_id
            else uuid.uuid4().hex[:16]
        )
    if not request_id:
        request_id = uuid.uuid4().hex[:16]
    return trace_id, uuid.uuid4().hex[:16], request_id


class _NoopRequest:
    """Disabled path: attribute-compatible with RequestTelemetry,
    shared and allocation-free (the perf-floor contract)."""

    __slots__ = ()
    ctx = None
    request_id = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def first_byte(self):
        return None

    def finish(self, *a, **kw):
        return None


NOOP_REQUEST = _NoopRequest()


class RequestTelemetry:
    """One proxy request's telemetry: a trace scope for the dispatch
    body plus the ``serve:ingress`` root span + histograms emitted at
    finish(). Used as a context manager around the dispatch so spans
    emitted downstream (queue/replica/engine) parent under the ingress
    span."""

    __slots__ = ("trace_id", "span_id", "request_id", "start", "_ttft",
                 "_token")

    def __init__(self, headers: dict):
        self.trace_id, self.span_id, self.request_id = adopt_or_mint(
            headers
        )
        self.start = time.time()
        self._ttft: float | None = None
        self._token = None

    @property
    def ctx(self) -> tuple[str, str]:
        return (self.trace_id, self.span_id)

    def __enter__(self):
        self._token = tracing._current.set(self.ctx)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            tracing._current.reset(self._token)
            self._token = None
        return False

    def first_byte(self):
        """Mark time-to-first-token/byte (streams call it on the first
        SSE frame; the unary path lets finish() default it to the full
        latency)."""
        if self._ttft is None:
            self._ttft = time.time() - self.start

    def finish(
        self,
        app: str,
        deployment: str,
        route: str,
        status: int,
        streamed: bool = False,
        items: int = 0,
    ) -> None:
        """Emit the ingress span + per-deployment histograms. Called
        once, after the response (or stream) is fully written."""
        dur = time.time() - self.start
        ttft = self._ttft if self._ttft is not None else dur
        tags = {"app": app, "deployment": deployment}
        REQUEST_LATENCY.observe(dur, tags=tags)
        TTFT.observe(ttft, tags=tags)
        outcome = (
            "ok" if status < 400 else
            "timeout" if status == 408 else "error"
        )
        REQUESTS.inc(tags={**tags, "outcome": outcome})
        tracing.record_span(
            self.trace_id, self.span_id, "", "serve:ingress",
            self.start, dur,
            app=app, deployment=deployment, route=route,
            status=int(status), ttft_s=round(ttft, 6),
            request_id=self.request_id, streamed=bool(streamed),
            items=int(items),
        )


def begin_request(headers: dict):
    """Proxy entry hook: RequestTelemetry when serve telemetry is on,
    the shared no-op otherwise (one config lookup on the disabled
    path)."""
    if not enabled():
        return NOOP_REQUEST
    return RequestTelemetry(headers)


def record_queue_wait(app: str, deployment: str, start: float,
                      dur: float) -> None:
    """Router-side: one replica-slot acquisition, emitted as a
    ``serve:queue`` span under the active (ingress) trace context.
    Rate-limited through the collective flight recorder's high-rate
    sampler so a slot-storm of sub-ms acquisitions cannot evict real
    events from the head's ring buffer."""
    from ray_tpu_torch.collective import flight_recorder

    emit, n = flight_recorder.span_sample(
        f"{app}/{deployment}", "serve:queue", dur
    )
    if not emit:
        return
    attrs = {"app": app, "deployment": deployment}
    if n > 1:
        attrs["sample_rate"] = n
    tracing.emit_span("serve:queue", start, dur, **attrs)


def record_token_span(deployment: str, start: float, dur: float,
                      tokens: int) -> None:
    """Engine-side: one streamed decode delta as a ``serve:token`` span
    under the active trace context, through the same high-rate sampler
    (a 100-token/s stream per request would otherwise be a span storm)."""
    from ray_tpu_torch.collective import flight_recorder

    emit, n = flight_recorder.span_sample(deployment, "serve:token", dur)
    if not emit:
        return
    attrs = {"deployment": deployment, "tokens": int(tokens)}
    if n > 1:
        attrs["sample_rate"] = n
    tracing.emit_span("serve:token", start, dur, **attrs)


def record_engine_phases(deployment: str, timing: dict | None,
                         tokens: int) -> None:
    """Engine-side: emit ``serve:prefill`` and ``serve:decode`` spans
    from the engine's per-request timing (under the active replica span)
    and observe per-output-token time. Safe on partial timing (aborted
    or legacy requests)."""
    if not timing:
        return
    pf_start = timing.get("prefill_start_ts")
    first = timing.get("first_token_ts")
    finish = timing.get("finish_ts")
    if pf_start and first and first >= pf_start:
        tracing.emit_span(
            "serve:prefill", pf_start, first - pf_start,
            deployment=deployment,
            queue_s=round(timing.get("queue_s", 0.0), 6),
        )
    if first and finish and finish >= first:
        decode_s = finish - first
        tracing.emit_span(
            "serve:decode", first, decode_s,
            deployment=deployment, tokens=int(tokens),
        )
        if tokens > 1:
            TPOT.observe(
                decode_s / (tokens - 1), tags={"deployment": deployment}
            )


def set_engine_gauges(deployment: str, active: int, max_batch: int,
                      pages_free: int | None,
                      pages_total: int | None) -> None:
    """Engine pump hook: decode-slot occupancy + paged-KV utilization."""
    if max_batch > 0:
        BATCH_OCCUPANCY.set(
            active / max_batch, tags={"deployment": deployment}
        )
    if pages_total:
        KV_CACHE_UTIL.set(
            (pages_total - (pages_free or 0)) / pages_total,
            tags={"deployment": deployment},
        )
