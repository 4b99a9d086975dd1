"""Train-step telemetry: phase spans, per-step MFU, goodput events.

Always-cheap instrumentation for the train loop (reference intent:
ray.train's TrainingReport/metrics plumbing plus the per-step profiling
the BENCH/PROFILE rounds hand-rolled). A step is wrapped by
``ray_tpu_torch.train.step_span()`` (or closed implicitly by ``report()``); on
completion it

- observes per-phase durations into ``ray_tpu_train_step_phase_seconds``
  (data-wait / compute / collective / checkpoint / whole step),
- computes per-step MFU from the step's FLOP count against the GPU's
  dense bf16 peak (by ``torch.cuda.get_device_name``) times the process
  group's world size, and sets ``ray_tpu_train_mfu``,
- emits ``train:step`` / ``train:<phase>`` SPAN events onto the
  task-event pipeline. Rank 0's step spans are what the head folds into
  per-job **goodput** (productive step time vs. time lost to stalls and
  attempt restarts — see HeadService._train_step_event); all ranks'
  spans render as slices in ``ray_tpu_torch timeline``.

Disable with RAY_TPU_TRAIN_TELEMETRY=0: ``step()`` then hands back a
shared no-op timer whose overhead a perf-floor test pins
(tests/test_perf_floors.py), so telemetry can never quietly tax the
train loop.
"""

from __future__ import annotations

import contextlib
import time

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# Dense bf16 FLOP/s per GPU by name (NVIDIA data sheets, SXM parts: the
# Hopper cards the kernels are built for); the H100's is the default, also
# for a process without a GPU.
PEAK_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
}
DEFAULT_PEAK_FLOPS = 989e12

STEP_PHASE_SECONDS = Histogram(
    "ray_tpu_train_step_phase_seconds",
    "train step time by phase ('step' = the whole step)",
    boundaries=(
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0,
    ),
    tag_keys=("job", "phase"),
)
MFU_GAUGE = Gauge(
    "ray_tpu_train_mfu",
    "model FLOPs utilization of this worker's most recent step",
    tag_keys=("job",),
)
STEPS_TOTAL = Counter(
    "ray_tpu_train_steps_total",
    "completed train steps",
    tag_keys=("job",),
)
COMM_EXPOSED_RATIO = Gauge(
    "ray_tpu_train_comm_exposed_ratio",
    "fraction of the most recent step spent in collective ops NOT "
    "overlapped with compute (flight-recorder op intervals intersected "
    "with the step's compute phase) — the baseline the compute-"
    "collective overlap work must move",
    tag_keys=("job",),
)


def telemetry_enabled() -> bool:
    from ray_tpu_torch._private import config

    return config.get("TRAIN_TELEMETRY")


def peak_flops_per_chip() -> float:
    import torch

    if not torch.cuda.is_available():
        return DEFAULT_PEAK_FLOPS
    name = torch.cuda.get_device_name().lower().replace(" ", "")
    for key, flops in PEAK_FLOPS.items():
        if key in name:
            return flops
    return DEFAULT_PEAK_FLOPS


class _NoopPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class NoopStepTimer:
    """Disabled path: attribute-compatible with StepTimer, shared and
    allocation-free."""

    __slots__ = ()
    phases: dict = {}
    _noop = _NoopPhase()

    def phase(self, name: str):
        return self._noop


NOOP_STEP = NoopStepTimer()


class StepTimer:
    """Measures one train step and its phases. Phase timing is a
    perf_counter pair and a dict store; span/metric emission happens
    once, at step end (finish_step)."""

    __slots__ = ("phases", "flops", "start", "_t0", "_events")

    def __init__(self, flops: float | None = None):
        self.phases: dict[str, float] = {}
        self.flops = flops
        self.start = time.time()
        self._t0 = time.perf_counter()
        # (name, wall_start, dur) per phase invocation, for timeline
        # slices placed at their true offsets.
        self._events: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            d = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + d
            self._events.append((name, wall, d))

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


def _merge_intervals(
    intervals: list[tuple[float, float]],
) -> list[tuple[float, float]]:
    """Union of possibly-overlapping (start, end) intervals (concurrent
    collective ops must not double-count wall time)."""
    out: list[list[float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap_seconds(
    a: list[tuple[float, float]], b: list[tuple[float, float]]
) -> float:
    """Total measure of the intersection of two MERGED interval lists."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def comm_attribution(
    step_start: float,
    step_end: float,
    compute_events: list[tuple[str, float, float]],
) -> tuple[float, float]:
    """(comm_exposed_s, comm_overlapped_s) for one step: drain the
    flight recorder's completed-op intervals, clamp them to the step
    window, and split their union by intersection with the union of the
    step's ``compute`` phase intervals. An op fully inside compute is
    overlapped (hidden behind the math); everything else is exposed
    stall. With today's serial step loop the overlap is ~0 — recorded
    honestly, which is exactly what makes it a movable baseline."""
    from ray_tpu_torch.collective import flight_recorder

    ops = flight_recorder.take_op_intervals()
    clamped = [
        (max(s, step_start), min(e, step_end))
        for s, e in ops
        if e > step_start and s < step_end
    ]
    if not clamped:
        return 0.0, 0.0
    op_union = _merge_intervals(clamped)
    total = sum(e - s for s, e in op_union)
    compute = _merge_intervals(
        [(wall, wall + d) for name, wall, d in compute_events
         if name == "compute"]
    )
    overlapped = _overlap_seconds(op_union, compute)
    return max(0.0, total - overlapped), overlapped


def compute_mfu(flops: float | None, dur: float) -> float | None:
    """``flops`` over ``dur`` seconds at the peak of every GPU of the
    step's process group (one GPU without a group)."""
    if not flops or dur <= 0:
        return None
    import torch.distributed as dist

    n_gpus = dist.get_world_size() if dist.is_initialized() else 1
    return flops / (dur * peak_flops_per_chip() * n_gpus)


def finish_step(ctx, timer: StepTimer) -> None:
    """Close a completed step: metrics + SPAN emission + context
    bookkeeping. Called only on the step's success path — a step that
    raised must not count as productive time (its tail shows up as
    restart loss in the head's goodput accounting instead)."""
    dur = timer.elapsed()
    job = ctx.experiment_name
    STEPS_TOTAL.inc(tags={"job": job})
    STEP_PHASE_SECONDS.observe(dur, tags={"job": job, "phase": "step"})
    for ph, s in timer.phases.items():
        STEP_PHASE_SECONDS.observe(s, tags={"job": job, "phase": ph})
    mfu = compute_mfu(timer.flops, dur)
    if mfu is not None:
        MFU_GAUGE.set(mfu, tags={"job": job})
    exposed, overlapped = comm_attribution(
        timer.start, timer.start + dur, timer._events
    )
    if (exposed or overlapped) and dur > 0:
        COMM_EXPOSED_RATIO.set(exposed / dur, tags={"job": job})
    loss = getattr(timer, "loss", None)
    _emit_step_span(
        ctx, timer.start, dur, phases=dict(timer.phases), mfu=mfu,
        degraded_frac=_take_degraded_frac(ctx),
        comm_exposed_s=exposed, comm_overlapped_s=overlapped,
        loss=float(loss) if isinstance(loss, (int, float)) else None,
    )
    from ray_tpu_torch.util import tracing

    for name, wall, d in timer._events:
        tracing.emit_span(
            f"train:{name}", wall, d,
            train_job=job, train_attempt=ctx.attempt, train_rank=ctx.rank,
        )
    ctx._step_index += 1
    ctx._used_step_timer = True
    ctx._last_report_wall = time.time()
    # Step profiler boundary: starts/advances/closes an armed
    # torch.profiler capture (train/profile.py). Two-branch no-op while
    # disarmed (pinned by the perf-floor test); never raises.
    from ray_tpu_torch.train import profile as _profile

    _profile.step_hook(ctx, dur)
    # Per-step memory sample (device by_kind + headroom + host RSS →
    # mem:sample span → head memory ledger). Last: it may raise the
    # RAY_TPU_FAKE_HBM_GB injected ResourceExhausted, and the step's
    # own accounting must already be closed when it does.
    from ray_tpu_torch.runtime import memory as _mem

    _mem.step_sample(ctx)


def implicit_step(ctx, now: float, metrics: dict) -> None:
    """report()-closed step for loops that never use step_span():
    the stretch since the previous report (or loop start) is one step.
    Keeps goodput accounting working for every existing train loop."""
    base = ctx._last_report_wall or ctx._loop_start_wall
    if base is None:
        return
    dur = max(0.0, now - base)
    job = ctx.experiment_name
    STEPS_TOTAL.inc(tags={"job": job})
    STEP_PHASE_SECONDS.observe(dur, tags={"job": job, "phase": "step"})
    mfu = metrics.get("mfu") if isinstance(metrics, dict) else None
    mfu = float(mfu) if isinstance(mfu, (int, float)) else None
    if mfu is not None:
        MFU_GAUGE.set(mfu, tags={"job": job})
    phases = {}
    ckpt_s = getattr(ctx, "_last_checkpoint_s", 0.0)
    if ckpt_s:
        phases["checkpoint"] = ckpt_s
        STEP_PHASE_SECONDS.observe(
            ckpt_s, tags={"job": job, "phase": "checkpoint"}
        )
    # No phase events on the implicit path — with nothing marked as
    # compute, every collective second in the window is exposed, which
    # is the honest reading of an unannotated loop.
    exposed, overlapped = comm_attribution(base, now, [])
    if exposed and dur > 0:
        COMM_EXPOSED_RATIO.set(exposed / dur, tags={"job": job})
    loss = metrics.get("loss") if isinstance(metrics, dict) else None
    _emit_step_span(
        ctx, base, dur, phases=phases, mfu=mfu,
        degraded_frac=_take_degraded_frac(ctx),
        comm_exposed_s=exposed, comm_overlapped_s=overlapped,
        loss=float(loss) if isinstance(loss, (int, float)) else None,
    )
    ctx._step_index += 1
    from ray_tpu_torch.runtime import memory as _mem

    _mem.step_sample(ctx)


def _take_degraded_frac(ctx) -> float:
    """Drain this step's partial-collective skip fractions into one
    degraded fraction (the worst op bounds the step: a gradient sync
    that excluded 1/4 of the ranks degrades the whole step's update by
    that fraction, however many clean ops surrounded it)."""
    fracs = getattr(ctx, "_partial_fracs", None)
    if not fracs:
        return 0.0
    frac = min(1.0, max(fracs))
    fracs.clear()
    return frac


def _emit_step_span(
    ctx, start, dur, phases, mfu, degraded_frac=0.0,
    comm_exposed_s=0.0, comm_overlapped_s=0.0,
    host_sync_exposed_s=0.0, loss=None,
) -> None:
    from ray_tpu_torch.util import tracing

    attrs = dict(
        train_job=ctx.experiment_name,
        train_attempt=ctx.attempt,
        train_rank=ctx.rank,
        train_step=ctx._step_index,
        phases=phases,
    )
    if mfu is not None:
        attrs["mfu"] = round(mfu, 6)
    if loss is not None:
        # The sweep engine's ledger-driven schedulers read this from
        # the head's train_stats fold — report({"loss": ...}) is the
        # whole reporting path a trial needs.
        attrs["loss"] = loss
    if degraded_frac:
        attrs["degraded_frac"] = round(degraded_frac, 6)
    if comm_exposed_s or comm_overlapped_s:
        attrs["comm_exposed_s"] = round(comm_exposed_s, 6)
        attrs["comm_overlapped_s"] = round(comm_overlapped_s, 6)
    if host_sync_exposed_s:
        attrs["host_sync_exposed_s"] = round(host_sync_exposed_s, 6)
    tracing.emit_span("train:step", start, dur, **attrs)
