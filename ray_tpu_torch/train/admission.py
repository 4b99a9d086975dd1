"""Gang admission for the sweep engine: fits-in-HBM × healthy-GPUs.

The memory planner (train/memory.py) answers "does this config fit one
chip"; the head's slice/node tables answer "how many chips are actually
healthy right now". A trial gang is admitted only when both say yes —
admitting on raw capacity would place gangs onto draining nodes or
configs the first step would OOM, and the sweep would spend its makespan
on restart churn instead of trials.

Used by tune/sweep.py before every gang launch (and re-admission after
a preemption); usable standalone as ``train.admission.admit_gang``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

logger = logging.getLogger("ray_tpu_torch.train")


@dataclass(frozen=True)
class AdmissionTicket:
    """One admission decision; ``admitted`` only when the gang both
    fits per-chip HBM and has enough healthy chips free."""

    admitted: bool
    reason: str
    required_chips: float
    free_chips: float
    total_chips: float
    plan: object | None = None  # MemoryPlan when a model spec was priced

    def __bool__(self) -> bool:
        return self.admitted


def cluster_chips(status: dict | None = None) -> tuple[float, float]:
    """(free, total) GPUs on HEALTHY nodes: not draining, and not
    members of a slice that is itself draining/dead (a slice dies as a
    unit — its stray healthy hosts are condemned capacity). Falls back
    to CPU slots when the cluster reports no GPU resource at all, so
    the sweep engine packs correctly on CPU-only test rigs."""
    if status is None:
        status = _cluster_status()
    draining = set(status.get("draining") or {})
    sick_slices = {
        sid
        for sid, rec in (status.get("slices") or {}).items()
        if rec.get("state") != "healthy"
        or any(nid in draining for nid in rec.get("nodes") or ())
    }
    node_slice = {
        nid: sid
        for sid, rec in (status.get("slices") or {}).items()
        for nid in rec.get("nodes") or ()
    }
    nodes = status.get("nodes") or {}
    kind = "GPU" if any(
        (n.get("resources") or {}).get("GPU") for n in nodes.values()
    ) else "CPU"
    free = total = 0.0
    for nid, n in nodes.items():
        if nid in draining or node_slice.get(nid) in sick_slices:
            continue
        total += float((n.get("resources") or {}).get(kind, 0.0))
        free += float((n.get("available") or {}).get(kind, 0.0))
    return free, total


def _cluster_status() -> dict:
    import ray_tpu_torch

    rt = ray_tpu_torch.api._runtime
    return rt.run(rt.core.head.call("cluster_status"))


def admit_gang(
    num_workers: int,
    chips_per_worker: float = 1.0,
    *,
    plan_kwargs: dict | None = None,
    headroom_fraction: float | None = None,
    status: dict | None = None,
) -> AdmissionTicket:
    """Admission check for one trial gang.

    ``plan_kwargs`` (optional) prices the config through
    ``train.plan_memory``: ``{"cfg": <LlamaConfig>, "batch": ...,
    "seq": ..., **plan-kwargs}``. ``headroom_fraction`` (default knob
    ``TUNE_ADMISSION_HEADROOM``) additionally requires that fraction of
    usable HBM left free — a sweep packing many gangs wants margin the
    single-job planner doesn't."""
    from ray_tpu_torch._private import config as _config

    plan = None
    if plan_kwargs:
        from ray_tpu_torch.train.memory import plan as plan_memory

        kw = dict(plan_kwargs)
        plan = plan_memory(
            kw.pop("cfg"), kw.pop("batch"), kw.pop("seq"), **kw
        )
        if headroom_fraction is None:
            headroom_fraction = _config.get("TUNE_ADMISSION_HEADROOM")
        need_free = headroom_fraction * plan.usable_bytes
        if not plan.fits or plan.headroom_bytes < need_free:
            return AdmissionTicket(
                admitted=False,
                reason=(
                    f"memory plan rejects config: total "
                    f"{plan.total_gb:.2f} GiB vs usable "
                    f"{plan.usable_bytes / (1 << 30):.2f} GiB "
                    f"(headroom floor {headroom_fraction:.0%})"
                ),
                required_chips=num_workers * chips_per_worker,
                free_chips=0.0,
                total_chips=0.0,
                plan=plan,
            )
    free, total = cluster_chips(status)
    required = num_workers * max(0.0, chips_per_worker)
    if required > free:
        return AdmissionTicket(
            admitted=False,
            reason=(
                f"gang needs {required:g} healthy chips, "
                f"{free:g}/{total:g} free"
            ),
            required_chips=required,
            free_chips=free,
            total_chips=total,
            plan=plan,
        )
    return AdmissionTicket(
        admitted=True,
        reason="fits",
        required_chips=required,
        free_chips=free,
        total_chips=total,
        plan=plan,
    )
