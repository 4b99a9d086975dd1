"""Public exception types (reference: python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base for all framework errors."""


class RayTaskError(RayTpuError):
    """A task raised; the original traceback is in the message and the
    original exception (when picklable) in ``.cause``."""

    cause: Exception | None = None


class WorkerDiedError(RayTpuError):
    """The worker executing a task died (all retries exhausted)."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel()."""


class ActorDiedError(RayTpuError):
    """The actor's worker process is gone."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get timed out."""


class ObjectLostError(RayTpuError):
    """An object's value is unrecoverable (owner and copies gone)."""


class ReplicaDrainingError(RayTpuError):
    """A serve replica refused a new request because it is draining
    (scale-down retirement): it finishes its in-flight requests and
    then exits. The router treats this as a re-route signal — the
    request lands on a non-draining replica and the client never sees
    it — so it is only user-visible when raised from a bare actor call
    that bypassed the handle router."""

    def __init__(self, deployment: str = ""):
        self.deployment = deployment
        super().__init__(
            f"replica of deployment {deployment!r} is draining and "
            "accepts no new requests (re-route to a live replica)"
        )


class NoReplicaAvailableError(RayTpuError):
    """The handle router found NO routable replica — none registered,
    or every one is dead, draining, or circuit-breaker-open — for
    longer than SERVE_UNAVAILABLE_TIMEOUT_S. Saturated-but-alive
    replicas never raise this (the request queues instead). The HTTP
    proxy maps it to 503 with a ``Retry-After`` header of
    ``retry_after_s``."""

    def __init__(self, deployment: str = "", app: str = "",
                 retry_after_s: float = 1.0):
        self.deployment = deployment
        self.app = app
        self.retry_after_s = retry_after_s
        super().__init__(
            f"no routable replica for {app}/{deployment} (all dead, "
            f"draining, or circuit-open); retry after "
            f"{retry_after_s:.1f}s"
        )


class PreemptedError(RayTpuError):
    """This worker's node is DRAINING (preemption notice / operator
    drain) and an emergency checkpoint was just persisted: the train
    attempt unwinds now, at a step boundary, so the controller resizes
    and resumes losing at most one step instead of the whole
    inter-checkpoint interval."""

    def __init__(
        self,
        node_id: str | None = None,
        reason: str = "",
        deadline_ts: float | None = None,
    ):
        self.node_id = node_id
        self.reason = reason
        self.deadline_ts = deadline_ts
        nid = (node_id or "?")[:12]
        super().__init__(
            f"node {nid}… is draining ({reason or 'no reason given'}); "
            "emergency checkpoint taken, unwinding the attempt"
        )
