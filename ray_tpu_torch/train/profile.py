"""Step profiler: roofline floors + in-program step attribution (port of
ray_tpu/train/profile.py on ``torch.profiler``).

Everything the goodput plane measures (comm_exposed_ratio, phase spans)
stops at the step boundary; the step itself is a black box. This module
opens it, in two halves that join into one MFU decomposition:

**Static (analytic)** — :func:`analyze_train_step` prices per-category
floors of one train step from its config. The port has no HLO to walk,
so the floors come from the model's arithmetic: the matmul floor is the
model's FLOPs per step (``LlamaConfig.flops_per_token``) over the GPU's
dense bf16 peak (``telemetry.peak_flops_per_chip``); the collective floor
is the gradient bytes times the ring wire factor over the interconnect's
bandwidth (0 on one GPU). The layout and elementwise floors are left at 0:
without the compiled program's fusion boundaries there is no honest count
of their bytes. These are cost-model numbers, not measurements.

**Empirical (measured)** — a capture request (head ``profile_capture``
fan-out, or :func:`request_capture` locally) arms the per-step hook that
``telemetry.finish_step`` calls. At the next step boundary the hook wraps
PROFILE_CAPTURE_STEPS steps in ``tracing.torch_profile`` (CPU and CUDA
activity), sums the capture's kernel time per category
(``_private/kernel_profile.py``), and emits a ``profile:step`` span the
head folds into the goodput ledger (decomposition gauges + the
regression-sentinel fingerprint), with the reference's keys.

**The join** — :func:`attribution_report` decomposes the measured step
wall into compute_floor / comm_in_program / hbm_bound / host_gap /
unattributed shares and names the dominant non-compute consumer: the
answer to "where does the missing MFU go".

Failure contract: nothing here may break a training step. The hook is a
two-branch no-op while disarmed (pinned <50µs by the perf-floor test),
and every capture-path failure degrades to one warning log and disarms.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time

logger = logging.getLogger(__name__)

CATEGORIES = (
    "compute_floor", "comm_in_program", "hbm_bound", "host_gap",
    "unattributed",
)

# Peak HBM bandwidth per GPU, GB/s (NVIDIA data sheets, SXM parts: the
# bandwidth analogue of telemetry.PEAK_FLOPS); the H100's is the
# default, also for a process without a GPU.
HBM_GBPS = {
    "h100": 3350.0,
    "h200": 4800.0,
}
DEFAULT_HBM_GBPS = 3350.0

# Per-GPU NVLink bandwidth, GB/s, one direction (NVLink 4 on H100/H200
# SXM: 900 GB/s both directions together).
ICI_GBPS = {
    "h100": 450.0,
    "h200": 450.0,
}
DEFAULT_ICI_GBPS = 450.0


def _chip_table_lookup(table: dict[str, float], default: float) -> float:
    try:
        import torch

        if not torch.cuda.is_available():
            return default
        kind = torch.cuda.get_device_name().lower().replace(" ", "")
    # tpulint: allow(broad-except reason=device probing for a roofline denominator; any torch/driver failure falls back to the documented default rather than failing analysis)
    except Exception:  # noqa: BLE001 - no torch/devices: documented default
        return default
    for name, value in table.items():
        if name in kind:
            return value
    return default


def hbm_bandwidth_per_chip() -> float:
    """Peak HBM bytes/s of this host's GPU."""
    return _chip_table_lookup(HBM_GBPS, DEFAULT_HBM_GBPS) * 1e9


def ici_bandwidth_per_chip() -> float:
    """Peak NVLink bytes/s (one direction) of this host's GPU."""
    return _chip_table_lookup(ICI_GBPS, DEFAULT_ICI_GBPS) * 1e9


def collective_wire_factor(op: str, group: int | None) -> float:
    """Wire-traffic multiple of the buffer size for one collective on a
    ring of ``group`` members: allreduce moves 2(n-1)/n of the buffer
    per GPU, allgather/reduce-scatter (n-1)/n, permute 1."""
    n = group or 1
    if n <= 1:
        return 0.0
    base = op.replace("-start", "")
    if "all-reduce" in base or "allreduce" in base:
        return 2.0 * (n - 1) / n
    if ("all-gather" in base or "reduce-scatter" in base
            or "allgather" in base or "reducescatter" in base):
        return (n - 1) / n
    return 1.0


def price_categories(
    walk: dict,
    peak_flops: float | None = None,
    hbm_bps: float | None = None,
    ici_bps: float | None = None,
) -> dict:
    """Roofline-price a category table (``categories`` of flops / bytes
    per category, ``collective_ops`` of op / bytes / group) into
    per-category floor seconds. matmul takes max(flops-bound,
    bytes-bound); layout and elementwise are HBM-bound; collectives are
    wire time over the interconnect."""
    from ray_tpu_torch.train import telemetry

    peak = peak_flops or telemetry.peak_flops_per_chip()
    hbm = hbm_bps or hbm_bandwidth_per_chip()
    ici = ici_bps or ici_bandwidth_per_chip()
    cats = walk["categories"]
    floors = {}
    floors["matmul"] = max(
        cats["matmul"]["flops"] / peak, cats["matmul"]["bytes"] / hbm
    )
    floors["elementwise_fusion"] = cats["elementwise_fusion"]["bytes"] / hbm
    floors["layout"] = cats["layout"]["bytes"] / hbm
    wire = 0.0
    for op in walk["collective_ops"]:
        wire += op["bytes"] * collective_wire_factor(op["op"], op["group"])
    floors["collective"] = wire / ici
    return floors


def _finish_static(walk: dict, agg: dict) -> dict:
    floors = price_categories(walk)
    cats = walk["categories"]
    total_flops = sum(c["flops"] for c in cats.values())
    total_bytes = sum(c["bytes"] for c in cats.values())
    # Signature: the category shape of the program, stable across
    # processes. Rounded so float-noise in pricing can't fork
    # fingerprints.
    sig_src = json.dumps(
        {
            k: [round(v["flops"]), round(v["bytes"]), v["ops"]]
            for k, v in sorted(cats.items())
        },
        sort_keys=True,
    )
    return {
        "sig": hashlib.sha1(sig_src.encode()).hexdigest()[:16],
        "categories": {
            k: {**v, "floor_s": floors[k]} for k, v in cats.items()
        },
        "ideal_step_s": sum(floors.values()),
        "flops_total": total_flops,
        "bytes_total": total_bytes,
        "cost_analysis": agg,
        "collective_ops": len(walk["collective_ops"]),
        "while_trips": walk["while_trips"],
    }


def _world_size() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return max(1, dist.get_world_size())
    # tpulint: allow(broad-except reason=GPU counting for an MFU denominator only; degrade to single-GPU math)
    except Exception:  # noqa: BLE001
        pass
    return 1


def _config_sig(cfg, batch_size: int, seq: int, world: int) -> str:
    """A hash of the config (dtype and remat mode included), the batch,
    the sequence and the mesh: equal across processes for equal
    steps."""
    fields = {
        f.name: str(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
    }
    src = json.dumps(
        {"cfg": type(cfg).__name__, "fields": fields, "batch": batch_size,
         "seq": seq, "mesh": {"dp": world}},
        sort_keys=True,
    )
    return hashlib.sha1(src.encode()).hexdigest()[:16]


def analyze_train_step(
    cfg=None, batch_size: int = 8, seq: int | None = None
) -> dict:
    """Statically profile one data-parallel train step of ``cfg`` (no
    execution): the model's FLOPs per step as the matmul category, the
    fp32 gradient tree's allreduce over the process group as the one
    collective, layout and elementwise at 0 (see the module docstring).
    Defaults to the bench preset at its bench shapes; pass ``cfg`` (e.g.
    PRESETS['tiny']) for fast tests."""
    from ray_tpu_torch.models.llama import PRESETS

    if cfg is None:
        cfg = PRESETS["bench"]
    if seq is None:
        seq = min(2048, cfg.max_seq)
    world = _world_size()
    model_flops = cfg.flops_per_token(seq) * (batch_size * seq)
    zero = {"flops": 0.0, "bytes": 0.0, "ops": 0}
    walk = {
        "categories": {
            "matmul": {"flops": model_flops / world, "bytes": 0.0,
                       "ops": cfg.n_layers},
            "collective": dict(zero),
            "elementwise_fusion": dict(zero),
            "layout": dict(zero),
        },
        "collective_ops": [],
        "while_trips": {},
    }
    if world > 1:
        grad_bytes = 4.0 * cfg.num_params()
        walk["categories"]["collective"] = {
            "flops": 0.0, "bytes": grad_bytes, "ops": 1}
        walk["collective_ops"].append(
            {"op": "all-reduce", "bytes": grad_bytes, "group": world})
    static = _finish_static(walk, {})
    static["sig"] = _config_sig(cfg, batch_size, seq, world)
    static["batch_size"] = batch_size
    static["seq"] = seq
    static["model_flops_per_step"] = model_flops
    return static


# ------------------------------------------------------- attribution
def attribution_report(
    measured: dict,
    wall_s: float,
    steps: int,
    static: dict | None = None,
    model_flops_per_step: float | None = None,
) -> dict:
    """Join one capture's measured per-category seconds with the static
    roofline into the MFU decomposition.

    ``measured`` is ``kernel_profile.measured_category_seconds`` output
    for ``steps`` steps totalling ``wall_s`` host seconds. Per-step
    decomposition (seconds, then shares of the step wall):

    - compute_floor: matmul time — the analytic floor when a static
      profile is supplied (what a perfect program would still pay),
      else the measured matmul seconds;
    - comm_in_program: measured collective time inside the program;
    - hbm_bound: measured elementwise/fusion + layout time (bandwidth,
      not math);
    - host_gap: step wall the device spent idle (wall − device busy);
    - unattributed: the remainder (tracer gaps, measured matmul above
      the floor, uncategorized ops).

    Concurrent events (host ops on several threads, kernels on several
    streams) can sum past the wall; measured seconds are normalized by
    min(1, wall/busy) so shares stay meaningful on every backend.
    """
    steps = max(1, steps)
    wall_step = wall_s / steps
    cats = {k: v / steps for k, v in measured["categories"].items()}
    busy_step = measured["device_busy_s"] / steps
    scale = 1.0
    if busy_step > 0 and wall_step > 0:
        scale = min(1.0, wall_step / busy_step)
    matmul_s = cats["matmul"] * scale
    comm_s = cats["collective"] * scale
    hbm_s = (cats["elementwise_fusion"] + cats["layout"]) * scale
    host_gap_s = max(0.0, wall_step - busy_step * scale)
    compute_s = matmul_s
    if static is not None:
        floor = static["categories"]["matmul"]["floor_s"]
        if 0.0 < floor <= matmul_s:
            compute_s = floor
    used = compute_s + comm_s + hbm_s + host_gap_s
    unattributed_s = max(0.0, wall_step - used)
    seconds = {
        "compute_floor": compute_s,
        "comm_in_program": comm_s,
        "hbm_bound": hbm_s,
        "host_gap": host_gap_s,
        "unattributed": unattributed_s,
    }
    shares = {
        k: (v / wall_step if wall_step > 0 else 0.0)
        for k, v in seconds.items()
    }
    gaps = {k: v for k, v in seconds.items() if k != "compute_floor"}
    dominant = max(gaps, key=gaps.get) if wall_step > 0 else "unattributed"
    report = {
        "step_s": wall_step,
        "steps": steps,
        "device_busy_s": busy_step * scale,
        "seconds": {k: round(v, 6) for k, v in seconds.items()},
        "shares": {k: round(v, 6) for k, v in shares.items()},
        "dominant_gap": dominant,
        "sig": (static or {}).get("sig", ""),
    }
    flops = model_flops_per_step or (static or {}).get(
        "model_flops_per_step"
    )
    if flops and wall_step > 0:
        from ray_tpu_torch.train import telemetry

        peak = telemetry.peak_flops_per_chip() * _world_size()
        report["mfu"] = round(flops / (wall_step * peak), 6)
    return report


def _read_capture(cap) -> dict | None:
    """Measured category seconds of one ``tracing.torch_profile``
    capture; None when the profiler left nothing to read."""
    from ray_tpu_torch._private import kernel_profile

    if getattr(cap, "profile", None) is None:
        return None
    return kernel_profile.measured_category_seconds(cap.profile)


# -------------------------------------------------- capture machinery
# Module state machine, driven by the per-step hook telemetry calls.
# _armed is the single fast-path gate: False == hook returns in two
# branches (the pinned disabled path).
_armed = False
_lock = threading.Lock()
_pending_steps = 0
_active: dict | None = None
_statics: dict[str, dict] = {}  # job → static profile (register_static)
_last_reports: dict[str, dict] = {}  # job → last attribution report


def profiling_enabled() -> bool:
    from ray_tpu_torch._private import config

    return config.get("PROFILE")


def register_static(job: str, static: dict) -> None:
    """Attach a static profile to a job so captures join against its
    analytic floors and fingerprint signature."""
    _statics[job] = static


def request_capture(steps: int | None = None) -> None:
    """Arm the step hook: the next step boundary starts a trace of
    ``steps`` (default PROFILE_CAPTURE_STEPS) steps."""
    global _armed, _pending_steps
    if not profiling_enabled():
        logger.warning(
            "profile capture requested but RAY_TPU_PROFILE=0; ignoring"
        )
        return
    if steps is None:
        from ray_tpu_torch._private import config

        steps = config.get("PROFILE_CAPTURE_STEPS")
    with _lock:
        _pending_steps = max(1, int(steps))
        _armed = True


def note_capture_request(msg: dict) -> None:
    """Pubsub fan-out entry point (head ``profile_capture`` event on the
    collective channel)."""
    request_capture(msg.get("steps"))


def last_report(job: str | None = None) -> dict | None:
    if job is not None:
        return _last_reports.get(job)
    for rep in _last_reports.values():
        return rep
    return None


def step_hook(ctx, step_s: float) -> None:
    """Per-step profiler hook, called by telemetry.finish_step on the
    step success path. MUST never raise and must cost nothing while
    disarmed (the perf-floor test pins this branch)."""
    global _armed, _active, _pending_steps
    if not _armed:
        return
    try:
        _step_hook_armed(ctx, step_s)
    # tpulint: allow(broad-except reason=capture failures must degrade to a warning, never an exception in the step loop — the acceptance contract of this plane)
    except Exception:  # noqa: BLE001
        logger.warning(
            "profile capture failed; disarming", exc_info=True
        )
        act = _active
        with _lock:
            _active = None
            _pending_steps = 0
            _armed = False
        if act is not None:
            try:
                act["cm"].__exit__(None, None, None)
            # tpulint: allow(broad-except reason=closing a profiler that already failed; the warning above reports the capture)
            except Exception:  # noqa: BLE001
                pass


def _step_hook_armed(ctx, step_s: float) -> None:
    global _armed, _active, _pending_steps
    with _lock:
        if _active is None:
            if _pending_steps <= 0:
                _armed = False
                return
            steps = _pending_steps
            _pending_steps = 0
            from ray_tpu_torch.util import tracing

            cm = tracing.torch_profile()
            cap = cm.__enter__()
            _active = {
                "cm": cm,
                "cap": cap,
                "left": steps,
                "steps": steps,
                "wall": 0.0,
                "t0": time.time(),
            }
            return
        act = _active
        act["left"] -= 1
        act["wall"] += step_s
        if act["left"] > 0:
            return
        _active = None
        if _pending_steps <= 0:
            _armed = False
    act["cm"].__exit__(None, None, None)
    _finish_capture(ctx, act)


def _finish_capture(ctx, act: dict) -> None:
    cap = act["cap"]
    path = cap.path
    measured = _read_capture(cap)
    if measured is None:
        logger.warning(
            "profile capture left no profiler events under %r", path
        )
        return
    job = ctx.experiment_name
    static = _statics.get(job)
    report = attribution_report(
        measured, act["wall"], act["steps"], static=static
    )
    if not report["sig"]:
        report["sig"] = job  # fingerprint key without a static profile
    report["path"] = path
    report["measured"] = measured
    _last_reports[job] = report
    from ray_tpu_torch.util import tracing

    tracing.emit_span(
        "profile:step",
        act["t0"],
        act["wall"],
        train_job=job,
        train_rank=ctx.rank,
        train_attempt=ctx.attempt,
        profile_sig=report["sig"],
        profile_steps=act["steps"],
        profile_step_s=round(report["step_s"], 6),
        profile_shares=report["shares"],
        profile_dominant=report["dominant_gap"],
        profile_measured_s={
            k: round(v, 6) for k, v in measured["categories"].items()
        },
        path=path or "",
    )
    logger.info(
        "profile capture %s: step %.4fs dominant_gap=%s shares=%s",
        job, report["step_s"], report["dominant_gap"], report["shares"],
    )


def _reset_for_tests() -> None:
    global _armed, _pending_steps, _active
    with _lock:
        _armed = False
        _pending_steps = 0
        _active = None
    _statics.clear()
    _last_reports.clear()


def profile_train_step(
    cfg=None, batch_size: int = 8, seq: int | None = None,
    steps: int | None = None, *, device: str = "cuda", state=None,
    optimizer=None, batch: dict | None = None, warmup: int = 2,
) -> dict:
    """One-process convenience (the CPU acceptance test, the chip proof):
    statically profile the train step of ``cfg``, run ``steps`` of it
    under the tracer after ``warmup`` steps, and return the joined
    attribution report (the static profile under ``"static"``, the
    measured categories and kernels under ``"measured"``, the state
    after the steps under ``"state"``).

    ``state`` / ``optimizer`` / ``batch`` reuse a caller's train state
    (and the optimizer it was built with) and tokens, and a caller whose
    state has stepped already may pass ``warmup=0``; by default a fresh
    state is drawn from seed 0 on ``device`` and the tokens from seed 1."""
    import numpy as np
    import torch

    from ray_tpu_torch._private import config
    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train.step import (
        init_train_state,
        jit_train_step,
        make_optimizer,
    )
    from ray_tpu_torch.util import tracing

    if cfg is None:
        cfg = PRESETS["bench"]
    if seq is None:
        seq = min(2048, cfg.max_seq)
    if steps is None:
        steps = config.get("PROFILE_CAPTURE_STEPS")
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            "profile_train_step on cuda needs a GPU; pass device='cpu'")
    if optimizer is None:
        optimizer = make_optimizer(total_steps=1000)
    if state is None:
        state = init_train_state(cfg, optimizer, seed=0, device=device)
    if batch is None:
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch_size, seq + 1))
        ).to(device)}
    step = jit_train_step(cfg, optimizer)
    static = analyze_train_step(cfg, batch_size=batch_size, seq=seq)

    def sync(metrics):
        float(metrics["loss"])  # a host read waits for the device

    # Warmup outside the trace, then capture.
    for _ in range(warmup):
        state, metrics = step(state, batch)
        sync(metrics)
    with tracing.torch_profile() as cap:
        # Timer starts inside: the profiler's start-up must not read as
        # host_gap.
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, batch)
        sync(metrics)
        wall = time.perf_counter() - t0
    measured = _read_capture(cap)
    if measured is None:
        raise RuntimeError(
            f"profiler left no events under {cap.path!r}"
        )
    report = attribution_report(measured, wall, steps, static=static)
    report["path"] = cap.path
    report["static"] = static
    report["measured"] = measured
    report["state"] = state
    return report
