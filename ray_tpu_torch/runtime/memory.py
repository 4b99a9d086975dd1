"""Device/host memory signal plane: HBM sampler, per-subsystem byte
attribution, headroom alerting, and OOM forensics.

The memory twin of the serve/goodput signal planes (PRs 2/9): every
byte of HBM and host RAM a subsystem pins is *accounted* (registration
hooks below), *alerted on* (headroom gauge + OFF→ON warn log), and
*explained on death* (a ResourceExhausted produces a ranked live-buffer
report instead of a bare stack trace). This is the instrument the
ZeRO-sharding work proves its capacity claim with — BENCH_8B's
``"peak_hbm_gb": null`` is exactly the blindness this removes.

Three data sources, in preference order:

1. the CUDA caching allocator (``torch.cuda.memory_stats()``:
   allocated bytes now and at peak; ``torch.cuda.mem_get_info()``: the
   card's capacity);
2. ``torch.cuda.memory_allocated()`` with the registration ledger where
   the allocator reports nothing in use;
3. the registration ledger alone in a process without a CUDA context.

The device is sampled only in a process where
``torch.cuda.is_initialized()``: a head, node or CPU worker never
creates a CUDA context for a sample (one costs about 0.5 GB of the
card), and never imports torch for one.

Host RSS comes from /proc/self/status (VmRSS).

Subsystems that own big buffers register them with :func:`track`
(returning a live :class:`Registration` they ``update()``/``close()``)
and optionally :func:`tag_arrays` so OOM forensics can name them:
trainer param/optimizer state (train/step.py), gradient-bucket scratch
(collective/bucketer.py), checkpoint host double-buffers
(checkpoint/saver.py, host-side), and paged-KV pools (llm/paged_kv.py).
Per-node samples ride the task-event pipeline as ``mem:sample`` spans;
the head folds them into the memory ledger (HeadService._mem_event →
``mem_stats`` RPC → /api/memory → ``ray_tpu_torch mem``).

Chaos: ``RAY_TPU_FAKE_HBM_GB`` caps the reported capacity so headroom
alerts and the OOM-forensics path are deterministically drivable
without real HBM pressure (a sampled usage above the fake cap raises
:class:`FakeResourceExhausted` at step close).

Disable with RAY_TPU_MEM_TELEMETRY=0: :func:`track` hands back a
shared no-op registration and :func:`step_sample` returns immediately;
a perf-floor test pins the disabled path under 50µs/step.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import sys
import threading
import time

from ray_tpu_torch.util.metrics import Gauge

logger = logging.getLogger("ray_tpu_torch.memory")

# The subsystem tag taxonomy (the `kind` label of ray_tpu_mem_hbm_bytes).
# "other" is the unattributed remainder of live bytes — a big "other" is
# itself a finding (an owner that never registered).
KINDS = (
    "params",
    "optimizer",
    "grads",
    "activations",
    "kv_cache",
    "collective_scratch",
    "other",
)

HBM_BYTES = Gauge(
    "ray_tpu_mem_hbm_bytes",
    "device memory bytes attributed per subsystem kind (params / "
    "optimizer / grads / activations / kv_cache / collective_scratch / "
    "other)",
    tag_keys=("kind",),
)
HBM_USED = Gauge(
    "ray_tpu_mem_hbm_used_bytes",
    "total device memory in use at the last sample",
)
HBM_PEAK = Gauge(
    "ray_tpu_mem_hbm_peak_bytes",
    "peak device memory in use observed by this process",
)
HBM_CAPACITY = Gauge(
    "ray_tpu_mem_hbm_capacity_bytes",
    "device memory capacity (backend bytes_limit, the device-kind "
    "table, or the RAY_TPU_FAKE_HBM_GB chaos cap)",
)
HBM_HEADROOM = Gauge(
    "ray_tpu_mem_headroom_bytes",
    "capacity minus used device bytes at the last sample (negative "
    "under the chaos cap = injected pressure)",
)
HOST_RSS = Gauge(
    "ray_tpu_mem_host_rss_bytes",
    "resident set size of this process (/proc/self/status VmRSS)",
)
HEADROOM_ALERT = Gauge(
    "ray_tpu_mem_headroom_alert",
    "1 when device headroom is below MEM_HEADROOM_ALERT_FRACTION of "
    "capacity (OFF→ON logs a warning)",
)

# Known device memory capacities by device-name substring (public spec
# sheets) — the fallback when the allocator reports no capacity.
DEVICE_HBM_GB = {
    "h100": 80.0,
}


def enabled() -> bool:
    from ray_tpu_torch._private import config

    return config.get("MEM_TELEMETRY")


class FakeResourceExhausted(MemoryError):
    """The injected stand-in for the backend's RESOURCE_EXHAUSTED:
    raised at step close when sampled usage exceeds the
    RAY_TPU_FAKE_HBM_GB chaos cap. Message-compatible with
    :func:`is_resource_exhausted` so every forensics path downstream
    treats it exactly like the real thing."""


def is_resource_exhausted(err: BaseException | None) -> bool:
    """True for the CUDA allocator's OOM (``torch.OutOfMemoryError``,
    "CUDA out of memory") and for the injected
    :class:`FakeResourceExhausted`."""
    if err is None:
        return False
    if isinstance(err, FakeResourceExhausted):
        return True
    name = type(err).__name__
    text = str(err)
    return (
        "RESOURCE_EXHAUSTED" in text
        or "OutOfMemoryError" in name
        or "CUDA out of memory" in text
    )


# --------------------------------------------------------------- registry
class Registration:
    """One subsystem's live byte claim. ``update(nbytes)`` is a plain
    attribute store (hot-path cheap; gauges are set only at sample
    time); ``close()`` retires the claim."""

    __slots__ = ("tag", "kind", "device", "nbytes", "_provider",
                 "_closed", "_leak_box", "__weakref__")

    def __init__(self, tag, kind, device, nbytes, provider):
        self.tag = tag
        self.kind = kind
        self.device = device
        self.nbytes = int(nbytes)
        self._provider = provider
        self._closed = False
        # Sanitizer leak box (sanitize.watch_registration): close()
        # marks it, a GC while open warns — TPU404's runtime twin.
        self._leak_box = None

    def update(self, nbytes: int) -> None:
        self.nbytes = int(nbytes)

    def add(self, nbytes: int) -> None:
        self.nbytes += int(nbytes)

    def current_bytes(self) -> int:
        if self._provider is not None:
            try:
                return int(self._provider())
            # tpulint: allow(broad-except reason=a registration provider crashing must degrade to the last pushed byte count, never fail the sampler)
            except Exception:  # noqa: BLE001
                return self.nbytes
        return self.nbytes

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._leak_box is not None:
                self._leak_box["closed"] = True
            with _reg_lock:
                if _registry.get(self.tag) is self:
                    del _registry[self.tag]

    # Context-manager support: `with memory.track(...):` is the
    # structurally paired form TPU404 never flags.
    def __enter__(self) -> "Registration":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _NoopRegistration:
    """Disabled-path registration: shared, allocation-free."""

    __slots__ = ()
    tag = ""
    kind = "other"
    device = True
    nbytes = 0

    def update(self, nbytes: int) -> None:
        pass

    def add(self, nbytes: int) -> None:
        pass

    def current_bytes(self) -> int:
        return 0

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NoopRegistration":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_REG = _NoopRegistration()

_reg_lock = threading.Lock()
_registry: dict[str, Registration] = {}
# id(array) → (tag, kind, weakref): forensic attribution for live
# buffers. The weakref is KEPT in the entry (a dead ref never fires its
# callback) so the callback can drop the entry when the array dies —
# otherwise a recycled id() would misattribute a new array to an old
# tag. Arrays that refuse weakrefs are simply not tagged (they rank as
# "other").
_array_tags: dict[int, tuple] = {}


def track(
    tag: str,
    kind: str = "other",
    nbytes: int = 0,
    provider=None,
    device: bool = True,
):
    """Register a subsystem's byte claim. ``tag`` is the unique
    registration site (re-tracking a tag replaces the old claim — the
    re-init case); ``kind`` buckets it into the metric taxonomy;
    ``provider`` (optional zero-arg callable) is consulted at sample
    time instead of the pushed ``nbytes``. ``device=False`` claims are
    host-side (checkpoint double-buffers) and fold into the host
    section of the sample. Returns the live :class:`Registration`
    (the shared no-op when telemetry is disabled)."""
    if not enabled():
        return NOOP_REG
    reg = Registration(tag, kind, device, nbytes, provider)
    from ray_tpu_torch._private import sanitize

    if sanitize.leaks_enabled():
        sanitize.watch_registration(reg)
    with _reg_lock:
        old = _registry.get(tag)
        _registry[tag] = reg
    if old is not None and old is not reg:
        # Re-tracking a tag replaces the claim; retire the old one so
        # its leak box doesn't cry wolf when it is collected.
        old.close()
    return reg


def tag_arrays(tag: str, kind: str, tree) -> None:
    """Attribute every array leaf of ``tree`` to (tag, kind) for OOM
    forensics. Weakref-based: tags die with their arrays."""
    if not enabled():
        return
    import weakref

    for leaf in _leaves(tree):
        if not hasattr(leaf, "nbytes"):
            continue
        key = id(leaf)

        def _drop(_ref, _key=key):
            _array_tags.pop(_key, None)

        try:
            ref = weakref.ref(leaf, _drop)
        except TypeError:
            continue  # not weakref-able: stays unattributed
        _array_tags[key] = (tag, kind, ref)


def _leaves(tree) -> list:
    """Leaves of a tree of dicts, lists and tuples (a state's tensors)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def registered_bytes(device: bool = True) -> dict[str, int]:
    """Current claims folded by kind (device- or host-side)."""
    out: dict[str, int] = {}
    with _reg_lock:
        regs = list(_registry.values())
    for reg in regs:
        if reg.device is device:
            out[reg.kind] = out.get(reg.kind, 0) + reg.current_bytes()
    return out


def clear_registry() -> None:
    """Drop every registration and array tag (test isolation)."""
    with _reg_lock:
        _registry.clear()
    _array_tags.clear()
    global _live_peak, _alert_on
    _live_peak = 0
    _alert_on = False


# --------------------------------------------------------------- sampling
_live_peak = 0  # process-local peak of sampled used bytes
_alert_on = False


def _cuda():
    """``torch.cuda`` in a process that already holds a CUDA context,
    else None: sampling never imports torch or creates a context."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


def _device_stats() -> dict | None:
    """The caching allocator's counters for the current device, mapped to
    bytes_in_use / peak_bytes_in_use / bytes_limit; None without a CUDA
    context."""
    cuda = _cuda()
    if cuda is None:
        return None
    try:
        stats = cuda.memory_stats()
        _free, total = cuda.mem_get_info()
    # tpulint: allow(broad-except reason=allocator probing on a dying or mid-teardown context falls through to the registration ledger rather than failing the sample)
    except Exception:  # noqa: BLE001
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def _live_array_bytes() -> int | None:
    cuda = _cuda()
    if cuda is None:
        return None
    try:
        return int(cuda.memory_allocated())
    # tpulint: allow(broad-except reason=allocator accounting fallback; a mid-teardown context degrades to the registration ledger, never fails the sample)
    except Exception:  # noqa: BLE001
        return None


def device_capacity_bytes() -> tuple[int | None, str]:
    """(capacity, source): the RAY_TPU_FAKE_HBM_GB chaos cap, the
    backend's bytes_limit, or the device-kind table. (None, "unknown")
    when nothing answers."""
    from ray_tpu_torch._private.test_utils import fake_hbm_cap_bytes

    fake = fake_hbm_cap_bytes()
    if fake is not None:
        return fake, "fake"
    stats = _device_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"]), "memory_stats"
    cuda = _cuda()
    if cuda is None:
        return None, "unknown"
    try:
        kind = cuda.get_device_name().lower()
    # tpulint: allow(broad-except reason=device-name probing for a capacity fallback; no device means no capacity, which is the honest answer)
    except Exception:  # noqa: BLE001
        return None, "unknown"
    for name, gb in DEVICE_HBM_GB.items():
        if name in kind:
            return int(gb * (1 << 30)), "device_kind"
    return None, "unknown"


def host_rss_bytes() -> int | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def _node_ident() -> str:
    """Stable per-node identity for the head ledger fold. The node
    address when a runtime is up (one sampler per worker folds into one
    node row), else host:pid."""
    try:
        import ray_tpu_torch.api as api

        core = getattr(api._runtime, "core", None)
        addr = getattr(core, "node_addr", None) if core else None
        if addr:
            return str(addr)
    # tpulint: allow(broad-except reason=node-identity probe outside a runtime; the host:pid fallback below is always valid)
    except Exception:  # noqa: BLE001
        pass
    return f"{socket.gethostname()}:{os.getpid()}"


def alert_fraction() -> float:
    from ray_tpu_torch._private import config

    return config.get("MEM_HEADROOM_ALERT_FRACTION")


def sample(job: str | None = None, emit: bool = True) -> dict | None:
    """Take one memory sample: device used/peak/capacity with per-kind
    attribution, host RSS, headroom + alert state. Sets every gauge,
    runs the OFF→ON alert log, and (``emit=True``) ships a
    ``mem:sample`` span for the head ledger. Returns the sample dict,
    or None when telemetry is disabled."""
    global _live_peak, _alert_on
    if not enabled():
        return None
    now = time.time()
    by_kind = registered_bytes(device=True)
    reg_total = sum(by_kind.values())
    stats = _device_stats()
    if stats and stats.get("bytes_in_use"):
        used = int(stats["bytes_in_use"])
        peak = int(stats.get("peak_bytes_in_use") or used)
        source = "memory_stats"
    else:
        live = _live_array_bytes()
        if live is not None:
            used = max(live, reg_total)
            source = "live_arrays"
        else:
            used = reg_total
            source = "registered"
        _live_peak = max(_live_peak, used)
        peak = _live_peak
    by_kind["other"] = max(0, used - reg_total)
    capacity, cap_source = device_capacity_bytes()
    headroom = capacity - used if capacity is not None else None
    host = {
        "rss_bytes": host_rss_bytes(),
        "by_kind": registered_bytes(device=False),
    }
    alert = bool(
        capacity
        and headroom is not None
        and headroom < capacity * alert_fraction()
    )
    if alert and not _alert_on:
        logger.warning(
            "device memory headroom low: %.2f GiB free of %.2f GiB "
            "(alert below %.0f%%) — top kinds: %s",
            (headroom or 0) / (1 << 30), capacity / (1 << 30),
            100.0 * alert_fraction(),
            ", ".join(
                f"{k}={v / (1 << 30):.2f}GiB"
                for k, v in sorted(
                    by_kind.items(), key=lambda kv: -kv[1]
                )[:3]
            ),
        )
    _alert_on = alert
    for kind, nbytes in by_kind.items():
        HBM_BYTES.set(float(nbytes), tags={"kind": kind})
    HBM_USED.set(float(used))
    HBM_PEAK.set(float(peak))
    if capacity is not None:
        HBM_CAPACITY.set(float(capacity))
        HBM_HEADROOM.set(float(headroom))
    if host["rss_bytes"] is not None:
        HOST_RSS.set(float(host["rss_bytes"]))
    HEADROOM_ALERT.set(1.0 if alert else 0.0)
    rec = {
        "ts": now,
        "node": _node_ident(),
        "job": job,
        "hbm": {
            "used_bytes": used,
            "peak_bytes": peak,
            "capacity_bytes": capacity,
            "headroom_bytes": headroom,
            "by_kind": by_kind,
            "source": source,
            "capacity_source": cap_source,
        },
        "host": host,
        "alert": alert,
    }
    if emit:
        from ray_tpu_torch.util import tracing

        tracing.emit_span(
            "mem:sample", now, 0.0,
            mem_node=rec["node"],
            mem_job=job,
            mem_used_bytes=used,
            mem_peak_bytes=peak,
            mem_capacity_bytes=capacity,
            mem_host_rss_bytes=host["rss_bytes"],
            mem_by_kind={k: v for k, v in by_kind.items() if v},
        )
    return rec


def step_sample(ctx) -> dict | None:
    """Per-step sampling hook (train/telemetry.py calls it at step
    close): one sample tagged with the job, then the chaos-cap OOM
    check — a sampled usage above RAY_TPU_FAKE_HBM_GB raises
    :class:`FakeResourceExhausted` *after* persisting its own forensics
    report, so the injected death leaves the same evidence a real one
    would."""
    if not enabled():
        return None
    job = getattr(ctx, "experiment_name", None)
    rec = sample(job=job)
    if rec is None:
        return None
    cap = rec["hbm"]["capacity_bytes"]
    if (
        rec["hbm"]["capacity_source"] == "fake"
        and cap
        and rec["hbm"]["used_bytes"] > cap
    ):
        err = FakeResourceExhausted(
            f"RESOURCE_EXHAUSTED: injected OOM — "
            f"{rec['hbm']['used_bytes']} bytes in use over the "
            f"RAY_TPU_FAKE_HBM_GB cap of {cap} bytes"
        )
        on_resource_exhausted(err, job=job)
        raise err
    return rec


# ----------------------------------------------------------- OOM forensics
def oom_report(top_n: int = 10) -> dict:
    """Ranked live-buffer report: the top-N live tagged tensors by
    nbytes (shape, dtype, owning subsystem tag) plus per-kind totals
    and the current sample — the "what ate the device memory" answer.
    The CUDA allocator enumerates no tensors, so the buffers are the
    ones :func:`tag_arrays` named; the sample holds the untagged rest."""
    buffers = []
    live = [
        arr for arr in (entry[2]() for entry in list(_array_tags.values()))
        if arr is not None
    ]
    for arr in live:
        tag, kind = _array_tags.get(id(arr), ("", "other"))[:2]
        try:
            buffers.append({
                "nbytes": int(arr.nbytes),
                "shape": list(getattr(arr, "shape", ())),
                "dtype": str(getattr(arr, "dtype", "?")),
                "tag": tag,
                "kind": kind,
            })
        # tpulint: allow(broad-except reason=one half-deleted buffer must not abort the whole OOM report)
        except Exception:  # noqa: BLE001
            continue
    buffers.sort(key=lambda b: -b["nbytes"])
    totals: dict[str, int] = {}
    for b in buffers:
        totals[b["kind"]] = totals.get(b["kind"], 0) + b["nbytes"]
    return {
        "buffers": buffers[:top_n],
        "live_buffers": len(buffers),
        "live_bytes": sum(b["nbytes"] for b in buffers),
        "bytes_by_kind": totals,
        "registered_by_kind": registered_bytes(device=True),
        "sample": sample(emit=False),
    }


def _report_dir() -> str:
    from ray_tpu_torch._private import config

    d = config.get("MEM_OOM_REPORT_DIR")
    if not d:
        import tempfile

        d = os.path.join(tempfile.gettempdir(), "ray_tpu_mem")
    os.makedirs(d, exist_ok=True)
    return d


def on_resource_exhausted(
    err: BaseException, job: str | None = None, top_n: int = 10
) -> str | None:
    """OOM forensics: build the ranked report, emit it as a ``mem:oom``
    span, persist it as JSON, and log the top consumer. Idempotent per
    error object (the injection path and the trainer's catch may both
    see the same exception). Returns the report path (None when
    telemetry is disabled)."""
    if not enabled():
        return None
    existing = getattr(err, "_mem_forensics_path", None)
    if existing is not None:
        return existing
    rep = oom_report(top_n=top_n)
    rep["error"] = f"{type(err).__name__}: {err}"[:500]
    rep["job"] = job
    now = time.time()
    path = os.path.join(
        _report_dir(), f"oom-{int(now)}-{os.getpid()}.json"
    )
    try:
        with open(path, "w") as f:
            json.dump(rep, f, indent=2)
    except OSError:
        path = None
    top = rep["buffers"][0] if rep["buffers"] else None
    logger.warning(
        "ResourceExhausted forensics: %d live buffers, %.2f GiB live; "
        "top consumer %s (%s, %.2f GiB); report: %s",
        rep["live_buffers"], rep["live_bytes"] / (1 << 30),
        (top or {}).get("tag") or (top or {}).get("kind") or "?",
        (top or {}).get("dtype", "?"),
        ((top or {}).get("nbytes") or 0) / (1 << 30),
        path or "<unwritable>",
    )
    from ray_tpu_torch.util import tracing

    tracing.emit_span(
        "mem:oom", now, 0.0,
        mem_node=_node_ident(),
        mem_job=job,
        mem_error=rep["error"],
        mem_live_bytes=rep["live_bytes"],
        mem_top=[
            {k: b[k] for k in ("nbytes", "kind", "tag", "dtype")}
            for b in rep["buffers"][:3]
        ],
        mem_report_path=path,
    )
    try:
        err._mem_forensics_path = path
    except AttributeError:
        pass  # exceptions with __slots__: forensics just reruns
    return path
