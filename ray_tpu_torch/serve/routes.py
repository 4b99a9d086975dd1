"""Controller route-table polling shared by the data-plane ingresses
(HTTP proxy + gRPC ingress). One implementation so controller-restart
recovery semantics stay in sync (reference: proxy_router.py — the
reference's proxies share one router/route-table updater the same way).
"""

from __future__ import annotations

import time

DEFAULT_TIMEOUT_S = 60.0


class RouteTablePoller:
    """TTL-cached view of the controller's route table: prefix →
    (app, ingress_deployment, request_timeout_s|None).

    Loop-native (runs on the runtime loop — get_actor/handle.result()
    would deadlock it). A failed poll drops the cached controller
    target so the next refresh re-resolves by name: the controller may
    have been restarted as a new actor while this ingress (detached)
    outlived a serve.shutdown/serve.run cycle.
    """

    def __init__(self, ttl_s: float = 2.0):
        self.routes: dict[str, tuple] = {}
        self._ttl_s = ttl_s
        self._ts = 0.0
        self._controller = None

    async def refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._ts < self._ttl_s and self.routes:
            return
        from ray_tpu_torch import api as core_api
        from ray_tpu_torch.runtime.core_worker import ActorSubmitTarget
        from ray_tpu_torch.serve.handle import CONTROLLER_NAME

        core = core_api._runtime.core
        if self._controller is None:
            reply = await core.head.call("get_actor", name=CONTROLLER_NAME)
            if not reply["ok"]:
                raise RuntimeError("serve controller is not running")
            self._controller = ActorSubmitTarget(
                reply["actor_id"], reply["addr"]
            )
        try:
            refs = await core.submit_task(
                "get_route_table",
                (),
                {},
                num_returns=1,
                actor=self._controller,
            )
            self.routes = (await core.get(refs))[0]
        except Exception:
            self._controller = None
            raise
        self._ts = time.monotonic()

    def by_app(self) -> dict[str, tuple]:
        """app → (ingress_deployment, request_timeout_s)."""
        out = {}
        for app_name, ingress, *rest in self.routes.values():
            timeout = (
                rest[0] if rest and rest[0] is not None else DEFAULT_TIMEOUT_S
            )
            out[app_name] = (ingress, timeout)
        return out
