"""User-defined metrics: Counter / Gauge / Histogram.

Reference: python/ray/util/metrics.py — tagged metrics defined in any
worker, exported cluster-wide. Here each process keeps a registry whose
snapshot rides the core worker's event-flush loop to the head
(reference pipeline: stats/metric.h → OpenTelemetryMetricRecorder →
per-node MetricsAgent → Prometheus scrape,
python/ray/_private/metrics_agent.py:628); `cluster_metrics()` merges
worker snapshots and `prometheus_text()` renders the exposition format a
scraper would consume.
"""

from __future__ import annotations

import bisect
import threading
from typing import Sequence

_REGISTRY: dict[str, "_Metric"] = {}
_LOCK = threading.Lock()

DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0
)


def escape_label_value(value) -> str:
    """Prometheus label-value escaping: one hostile value must not be
    able to break out of its quotes or inject exposition lines."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def parse_tag_str(tag_str: str) -> dict[str, str]:
    """Inverse of the snapshot tag rendering (`k="v",k2="v2"`, values
    escaped with escape_label_value)."""
    out: dict[str, str] = {}
    i, n = 0, len(tag_str)
    while i < n:
        eq = tag_str.find('="', i)
        if eq < 0:
            break
        key = tag_str[i:eq]
        j = eq + 2
        buf: list[str] = []
        while j < n:
            c = tag_str[j]
            if c == "\\" and j + 1 < n:
                buf.append({"n": "\n"}.get(tag_str[j + 1], tag_str[j + 1]))
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        out[key] = "".join(buf)
        i = j + 2  # past the closing quote and the separating comma
    return out


class _Metric:
    kind = ""

    def __new__(cls, name: str, *args, **kwargs):
        # Re-registration of an existing name with the same kind hands
        # back the live instance (its series survive) instead of
        # silently shadowing it; __init__ then verifies the shape.
        with _LOCK:
            existing = _REGISTRY.get(name)
        if existing is not None and type(existing) is cls:
            return existing
        return object.__new__(cls)

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Sequence[str] = (),
    ):
        tag_keys = tuple(tag_keys)
        if getattr(self, "_registered", False):
            if tag_keys != self.tag_keys:
                raise ValueError(
                    f"metric {name!r} already registered with tag_keys "
                    f"{self.tag_keys}, cannot re-register with {tag_keys}"
                )
            return
        with _LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None and existing is not self:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}, cannot re-register as {self.kind}"
                )
            self.name = name
            self.description = description
            self.tag_keys = tag_keys
            self._default_tags: dict[str, str] = {}
            # tag-value tuple → value (float for counter/gauge, list for
            # hist)
            self._series: dict[tuple, object] = {}
            self._registered = True
            _REGISTRY[name] = self

    def set_default_tags(self, tags: dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: dict[str, str] | None) -> tuple:
        merged = {**self._default_tags, **(tags or {})}
        unknown = set(merged) - set(self.tag_keys)
        if unknown:
            raise ValueError(
                f"tags {sorted(unknown)} not in tag_keys {self.tag_keys}"
            )
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def value(self, tags: dict[str, str] | None = None, default=None):
        """Read the current value for one tag set (counter/gauge: float;
        histogram: [bucket_counts, sum, count]). In-process observers —
        the collective straggler telemetry's tests, health checks —
        read this instead of round-tripping a snapshot."""
        with _LOCK:
            return self._series.get(self._key(tags), default)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with _LOCK:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None):
        with _LOCK:
            self._series[self._key(tags)] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = DEFAULT_BUCKETS,
        tag_keys: Sequence[str] = (),
    ):
        boundaries = tuple(sorted(boundaries))
        if (
            getattr(self, "_registered", False)
            and boundaries != self.boundaries
        ):
            raise ValueError(
                f"histogram {name!r} already registered with boundaries "
                f"{self.boundaries}, cannot re-register with {boundaries}"
            )
        super().__init__(name, description, tag_keys)
        self.boundaries = boundaries

    def observe(self, value: float, tags: dict | None = None):
        key = self._key(tags)
        with _LOCK:
            series = self._series.get(key)
            if series is None:
                # bucket counts (len+1 for +Inf), sum, count
                series = [[0] * (len(self.boundaries) + 1), 0.0, 0]
                self._series[key] = series
            idx = bisect.bisect_left(self.boundaries, value)
            series[0][idx] += 1
            series[1] += value
            series[2] += 1


def snapshot() -> dict:
    """Serializable {name: record} for this process's registry."""
    out = {}
    with _LOCK:
        for name, m in _REGISTRY.items():
            kind = m.kind
            series = {}
            for key, val in m._series.items():
                tag_str = ",".join(
                    f'{k}="{escape_label_value(v)}"'
                    for k, v in zip(m.tag_keys, key)
                )
                series[tag_str] = (
                    [list(val[0]), val[1], val[2]]
                    if kind == "histogram"
                    else val
                )
            if series:
                out[name] = {
                    "kind": kind,
                    "description": m.description,
                    "series": series,
                    "boundaries": getattr(m, "boundaries", None),
                }
    return out


def clear_registry():
    """Test helper: zero every metric without deregistering it.

    Live metric objects (module-level singletons like the collective
    flight recorder's) keep recording after a clear; dropping them from
    the registry would orphan them — still counting, never scraped."""
    with _LOCK:
        for m in _REGISTRY.values():
            m._series.clear()


def merge_snapshots(worker_snaps: dict[str, dict]) -> dict:
    """Merge per-worker snapshots: counters/histograms sum, gauges keep
    the per-worker latest under a worker tag."""
    merged: dict[str, dict] = {}
    for worker, snap in worker_snaps.items():
        for name, rec in snap.items():
            m = merged.setdefault(
                name,
                {
                    "kind": rec["kind"],
                    "description": rec["description"],
                    "series": {},
                    "boundaries": rec.get("boundaries"),
                },
            )
            for tag_str, val in rec["series"].items():
                if rec["kind"] == "gauge":
                    wtag = (
                        f'{tag_str},worker="{escape_label_value(worker)}"'
                    ).lstrip(",")
                    m["series"][wtag] = val
                elif rec["kind"] == "counter":
                    m["series"][tag_str] = m["series"].get(tag_str, 0.0) + val
                else:  # histogram
                    cur = m["series"].get(tag_str)
                    if cur is None:
                        m["series"][tag_str] = [
                            list(val[0]), val[1], val[2]
                        ]
                    else:
                        cur[0] = [a + b for a, b in zip(cur[0], val[0])]
                        cur[1] += val[1]
                        cur[2] += val[2]
    return merged


def prometheus_text(merged: dict) -> str:
    """Render merged metrics in Prometheus exposition format."""
    lines = []
    for name, rec in merged.items():
        if rec["description"]:
            # HELP is one line by format: a newline in a description
            # would start a bogus exposition line mid-scrape.
            desc = (
                rec["description"]
                .replace("\\", "\\\\")
                .replace("\n", " ")
            )
            lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {rec['kind']}")
        for tag_str, val in rec["series"].items():
            braces = f"{{{tag_str}}}" if tag_str else ""
            if rec["kind"] == "histogram":
                counts, total, n = val
                cum = 0
                for bound, c in zip(rec["boundaries"], counts):
                    cum += c
                    sep = "," if tag_str else ""
                    lines.append(
                        f'{name}_bucket{{{tag_str}{sep}le="{bound}"}} {cum}'
                    )
                sep = "," if tag_str else ""
                lines.append(
                    f'{name}_bucket{{{tag_str}{sep}le="+Inf"}} {n}'
                )
                lines.append(f"{name}_sum{braces} {total}")
                lines.append(f"{name}_count{braces} {n}")
            else:
                lines.append(f"{name}{braces} {val}")
    return "\n".join(lines) + "\n"
