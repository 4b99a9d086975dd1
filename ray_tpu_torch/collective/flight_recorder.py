"""Collective flight recorder: always-on, per-op telemetry.

Every collective verb (CPU hub-reduce and the XLA backends) records the
member-visible op latency into a Histogram, the per-rank payload bytes
into a Counter, and the derived achieved *bus* bandwidth into a Gauge —
the attribution layer papers like "Efficient AllReduce with Stragglers"
(arxiv 2505.23523) and T3 (arxiv 2401.16677) assume exists. Each op also
emits a SPAN event onto the task-event pipeline so `ray_tpu_torch timeline`
renders collective ops as slices alongside tasks (and, when the caller
runs under a trace context, parented to the issuing task's span).

Bus bandwidth follows the nccl-tests convention: busbw = algbw × a
verb-specific factor of the world size, where algbw = per-rank bytes /
op time. That makes numbers comparable across verbs and world sizes
(an allreduce moving N bytes/rank does ~2(n-1)/n × N of wire traffic).
"""

from __future__ import annotations

import threading
import time

from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

OP_LATENCY = Histogram(
    "ray_tpu_collective_op_latency_seconds",
    "member-visible collective op latency",
    boundaries=(
        0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
        1.0, 5.0, 30.0,
    ),
    tag_keys=("group", "verb", "backend"),
)
OP_BYTES = Counter(
    "ray_tpu_collective_bytes_total",
    "per-rank LOGICAL payload bytes moved by collective ops (the caller's "
    "tensor size; see ray_tpu_collective_wire_bytes_total for what "
    "actually crossed the wire)",
    tag_keys=("group", "verb", "dtype"),
)
WIRE_BYTES = Counter(
    "ray_tpu_collective_wire_bytes_total",
    "per-rank bytes this rank actually moved on the wire (compressed "
    "codecs and multi-phase algorithms diverge from the logical size)",
    tag_keys=("group", "verb", "dtype"),
)
COMPRESSION_RATIO = Gauge(
    "ray_tpu_collective_compression_ratio",
    "logical/wire byte ratio of the most recent collective op "
    "(1.0 = uncompressed; ~3.9 for the block-256 int8 codec)",
    tag_keys=("group", "verb"),
)
BUS_BANDWIDTH = Gauge(
    "ray_tpu_collective_bus_bandwidth_bytes_per_s",
    "achieved bus bandwidth of the most recent collective op "
    "(nccl-tests busbw convention)",
    tag_keys=("group", "verb", "dtype"),
)

DCN_CONTRIB = Counter(
    "ray_tpu_collective_dcn_contrib_total",
    "hierarchical-allreduce DCN hop participation by slice and outcome "
    "(contributed vs skipped) — the slice-level health signal the "
    "whole-slice drain escalation reads",
    tag_keys=("group", "slice", "outcome"),
)
DCN_BUS_BANDWIDTH = Gauge(
    "ray_tpu_collective_dcn_bus_bandwidth_bytes_per_s",
    "achieved DCN-hop bus bandwidth of the most recent hierarchical "
    "allreduce, per contributing slice (wire bytes of the inter-slice "
    "exchange / op time)",
    tag_keys=("group", "slice"),
)

PARTIAL_OPS = Counter(
    "ray_tpu_collective_partial_ops_total",
    "collective ops completed in K-of-N partial mode (skipped at least "
    "one straggler's contribution)",
    tag_keys=("group", "verb"),
)
PARTIAL_SKIPS = Counter(
    "ray_tpu_collective_partial_skips_total",
    "times this rank's contribution was skipped by a partial collective",
    tag_keys=("group", "rank"),
)

# verb → busbw factor as a function of world size (nccl-tests
# performance docs); verbs without an entry (send/recv/permute/
# broadcast/reduce) move each byte once → factor 1. `hier_allreduce`
# deliberately has NO entry: its wire traffic depends on the (s, m)
# slice split and on whether the DCN hop is int8-compressed, so a flat
# 2(n-1)/n factor over-reports busbw the moment compression="int8"
# shrinks the DCN bytes. The op always passes explicit wire_bytes=
# computed from its actual split (see algo.hierarchical_allreduce), and
# busbw derives from those measured bytes only.
_BUS_FACTORS = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "reducescatter": lambda n: (n - 1) / n,
}

# --------------------------------------------------- span rate limiting
# Metrics (histogram/counter/gauge) are always recorded — they aggregate.
# SPAN events are per-op list appends that ride the task-event pipeline;
# a >1 kHz storm of sub-ms ops (partial-mode retry storms, tight
# barrier loops) would evict every other event from the head's
# ring buffer. Above _AUTO_RATE_HZ ops/s, sub-_AUTO_DUR_S ops emit
# 1-in-_AUTO_SAMPLE spans (the span carries sample_rate so the timeline
# can re-weight); an explicit sample_rate arg on record_op overrides.
_AUTO_RATE_HZ = 1000
_AUTO_DUR_S = 0.001
_AUTO_SAMPLE = 100

_span_lock = threading.Lock()
# (group, verb) → [window_start_monotonic, ops_in_window, op_counter]
_span_state: dict[tuple, list] = {}


def span_sample(
    group: str, verb: str, dur: float, sample_rate: int | None = None
) -> tuple[bool, int]:
    """Public entry to the high-rate span sampler for other span
    sources with per-event storm potential (serve's per-token decode
    spans key it by (deployment, name)). Same contract as the private
    form below."""
    return _span_sample(group, verb, dur, sample_rate)


def _span_sample(
    group: str, verb: str, dur: float, sample_rate: int | None
) -> tuple[bool, int]:
    """(emit this op's span?, effective 1-in-N rate). N=1 → always."""
    with _span_lock:
        st = _span_state.get((group, verb))
        if st is None:
            if len(_span_state) > 512:  # bound: groups come and go
                _span_state.pop(next(iter(_span_state)))
            st = _span_state[(group, verb)] = [time.monotonic(), 0, 0]
        now = time.monotonic()
        if now - st[0] > 1.0:
            st[0], st[1] = now, 0
        st[1] += 1
        st[2] += 1
        counter, rate_1s = st[2], st[1]
    if sample_rate is not None and sample_rate > 1:
        n = int(sample_rate)
    elif rate_1s > _AUTO_RATE_HZ and dur < _AUTO_DUR_S:
        n = _AUTO_SAMPLE
    else:
        return True, 1
    return counter % n == 0, n


# ------------------------------------------------ op-interval ledger
# Wall-clock (start, end) of every collective op completed in this
# process, ring-bounded. The train step telemetry drains it at step
# close and intersects the intervals with the step's compute phase to
# split collective time into comm_exposed_s vs comm_overlapped_s — the
# baseline the T3-style overlap work must move (today nothing overlaps,
# and the ledger records that honestly rather than assuming it).
_ops_lock = threading.Lock()
_op_intervals: list[tuple[float, float]] = []
_OP_INTERVAL_CAP = 4096


def _note_op_interval(start: float, dur: float) -> None:
    with _ops_lock:
        _op_intervals.append((start, start + dur))
        if len(_op_intervals) > _OP_INTERVAL_CAP:
            del _op_intervals[: _OP_INTERVAL_CAP // 2]


def take_op_intervals() -> list[tuple[float, float]]:
    """Drain the completed-op (start, end) wall-clock intervals recorded
    since the last call (one consumer: the step telemetry)."""
    global _op_intervals
    with _ops_lock:
        out, _op_intervals = _op_intervals, []
    return out


def record_dcn_slices(
    group: str,
    contributed,
    skipped,
    dcn_bytes: int,
    dur: float,
) -> None:
    """Record one hierarchical allreduce's DCN hop at slice
    granularity: a contribution counter per slice (labeled by outcome)
    plus a per-slice DCN busbw gauge for the slices that carried
    traffic. Zero-DCN ops (single slice) record nothing."""
    if not skipped and not contributed:
        return
    for si in contributed:
        DCN_CONTRIB.inc(
            tags={
                "group": group, "slice": str(si), "outcome": "contributed",
            }
        )
        if dcn_bytes > 0 and dur > 0:
            DCN_BUS_BANDWIDTH.set(
                dcn_bytes / dur, tags={"group": group, "slice": str(si)}
            )
    for si in skipped:
        DCN_CONTRIB.inc(
            tags={"group": group, "slice": str(si), "outcome": "skipped"}
        )


def record_partial(group: str, verb: str, skipped) -> None:
    """Record one partial-mode completion: op counter + per-skipped-rank
    counter (the same per-rank series the chronic-straggler signal
    aggregates, plus the dedicated partial counters)."""
    PARTIAL_OPS.inc(tags={"group": group, "verb": verb})
    for r in skipped:
        PARTIAL_SKIPS.inc(tags={"group": group, "rank": str(r)})


def payload_info(tensor) -> tuple[int, str]:
    """(per-rank bytes, dtype string) of an op payload. A sequence of
    per-rank tensors (the single-controller mesh backend) reports one
    rank's slice — bandwidth math is per-rank by convention."""
    if tensor is None:
        return 0, "none"
    if isinstance(tensor, (list, tuple)):
        if not tensor:
            return 0, "none"
        tensor = tensor[0]
    nbytes = getattr(tensor, "nbytes", None)
    dtype = getattr(tensor, "dtype", None)
    if nbytes is None:
        try:
            import numpy as np

            arr = np.asarray(tensor)
            nbytes, dtype = arr.nbytes, arr.dtype
        # tpulint: allow(broad-except reason=an unconvertible payload records as size-less; telemetry must never fail the op it measures)
        except Exception:
            return 0, "unknown"
    return int(nbytes), str(dtype) if dtype is not None else "unknown"


def record_op(
    group: str,
    verb: str,
    backend: str,
    world: int,
    tensor,
    start: float,
    dur: float,
    sample_rate: int | None = None,
    wire_bytes: int | None = None,
) -> None:
    """Record one completed collective op (success path only — aborts
    and timeouts are counted by the fault-tolerance counters).

    ``sample_rate=N`` emits the timeline SPAN for 1-in-N ops (metrics
    are always recorded); with the default None, spans auto-sample at
    1-in-100 once a (group, verb) exceeds 1 kHz of sub-ms ops.

    ``wire_bytes`` is what this rank ACTUALLY moved on the wire when it
    differs from the logical payload size — compressed codecs,
    multi-phase ring/tree algorithms, the hierarchical two-level op.
    When given, the busbw gauge is computed from it directly
    (wire/dur — no verb factor, honest for any algorithm) and the
    logical/wire ratio lands in the compression-ratio gauge."""
    nbytes, dtype = payload_info(tensor)
    _note_op_interval(start, dur)
    OP_LATENCY.observe(
        dur, tags={"group": group, "verb": verb, "backend": backend}
    )
    attrs: dict = {"group": group, "verb": verb, "backend": backend}
    if nbytes:
        tags = {"group": group, "verb": verb, "dtype": dtype}
        OP_BYTES.inc(nbytes, tags=tags)
        attrs["bytes"] = nbytes
        attrs["dtype"] = dtype
        if wire_bytes is not None:
            WIRE_BYTES.inc(wire_bytes, tags=tags)
            attrs["wire_bytes"] = int(wire_bytes)
            if wire_bytes > 0:
                ratio = nbytes / wire_bytes
                COMPRESSION_RATIO.set(
                    ratio, tags={"group": group, "verb": verb}
                )
                attrs["compression_ratio"] = round(ratio, 3)
        if dur > 0:
            if wire_bytes is not None and wire_bytes > 0:
                bus = wire_bytes / dur
            else:
                factor = _BUS_FACTORS.get(verb)
                bus = (factor(world) if factor and world else 1.0) * (
                    nbytes / dur
                )
            BUS_BANDWIDTH.set(bus, tags=tags)
            attrs["bus_bytes_per_s"] = round(bus, 1)
    emit, n = _span_sample(group, verb, dur, sample_rate)
    if not emit:
        return
    if n > 1:
        attrs["sample_rate"] = n
    tracing.emit_span(f"collective:{verb}", start, dur, **attrs)
