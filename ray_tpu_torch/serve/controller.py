"""ServeController: the reconciliation brain of serve.

(reference: python/ray/serve/_private/controller.py:106 ServeController —
owns application/deployment target state, reconciles replica actors to
target counts (deployment_state.py), restarts dead replicas, and applies
autoscaling decisions from replica-reported queue lengths
(autoscaling_state.py).)

Runs as a detached named actor. Mutating RPCs are sync methods (the core
worker executes them in arrival order, serializing state changes); the
control loop is a long-lived async method running concurrently, which
talks to replicas through the core worker's coroutine API directly (it
cannot block the loop thread).

The control loop closes the serve signal plane into actions:

- **SLO-driven autoscaling** — demand (replica ongoing + handle-router
  queued) sets the desired replica count; the head serve ledger's SLO
  alert boosts it; hysteresis + cooldown knobs (``SERVE_AUTOSCALE_*``)
  keep an oscillating load from flapping the target. Decisions are
  reported to the head (``serve_autoscale_report``) and exported as the
  ``ray_tpu_serve_target_replicas`` gauge.
- **Zero-drop scale-down** — victims retire through a drain protocol:
  removed from the routed replica list (version bump), told to refuse
  new requests (typed ``ReplicaDrainingError`` the router re-routes
  on), killed only once in-flight work hits zero or
  ``SERVE_DRAIN_TIMEOUT_S`` expires.
- **Replica-kill survival** — dead replicas (3 missed polls, or a
  router's typed death observation) are dropped and replacements start
  on healthy, non-draining nodes; when slices are labeled, replicas
  spread across slice fault domains so one slice preemption cannot take
  out every replica.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ray_tpu_torch import api as core_api
from ray_tpu_torch.runtime.core_worker import ActorSubmitTarget
from ray_tpu_torch.serve.replica import ReplicaActor

_CONTROL_PERIOD_S = 0.25

logger = logging.getLogger(__name__)


def desired_replicas(
    ongoing: float,
    target_ongoing: float,
    min_replicas: int,
    max_replicas: int,
    slo_alert: bool = False,
    slo_boost: bool = True,
) -> int:
    """Demand-derived replica count: enough replicas to hold per-replica
    ongoing requests near target, plus one while the head reports the
    deployment's SLO alert ON (the ledger saw attainment below target —
    demand alone is lagging, so lean in)."""
    if ongoing > 0:
        want = int(-(-ongoing // max(target_ongoing, 1e-9)))
    else:
        want = min_replicas
    if slo_alert and slo_boost:
        want += 1
    return max(min_replicas, min(max_replicas, want))


def autoscale_decision(
    state: dict,
    desired: int,
    now: float,
    *,
    min_replicas: int,
    max_replicas: int,
    up_cooldown_s: float,
    down_cooldown_s: float,
    hysteresis: float,
) -> "str | None":
    """One autoscale step: move ``state['target']`` toward ``desired``
    with hysteresis and cooldowns. Pure against ``state`` + ``now`` so
    the no-flapping property is unit-testable without a cluster.

    - A desired within ``hysteresis * target`` of the current target is
      treated as equal (dead-band against demand noise).
    - Scale-UP applies after ``up_cooldown_s`` since the last up move.
    - Scale-DOWN requires desired to stay below target CONTINUOUSLY for
      ``down_cooldown_s``, and then drops only to the MAXIMUM desired
      seen during that window — an oscillating load keeps the window
      max high, so the target never chases the troughs (no flapping).

    Returns the decision reason ("up"/"down") when the target moved,
    else None. ``state`` keys used: target, last_scale_up,
    low_since, desired_window (list of (ts, desired))."""
    desired = max(min_replicas, min(max_replicas, int(desired)))
    target = state["target"]
    if abs(desired - target) <= hysteresis * target:
        desired = target
    window = state.setdefault("desired_window", [])
    window.append((now, desired))
    cutoff = now - max(down_cooldown_s, 1e-9)
    while window and window[0][0] < cutoff:
        window.pop(0)
    if desired > target:
        state["low_since"] = None
        if now - state.get("last_scale_up", -1e9) >= up_cooldown_s:
            state["target"] = desired
            state["last_scale_up"] = now
            return "up"
        return None
    if desired < target:
        if state.get("low_since") is None:
            state["low_since"] = now
            return None
        if now - state["low_since"] < down_cooldown_s:
            return None
        new_target = max(
            min_replicas,
            max((d for _ts, d in window), default=desired),
        )
        state["low_since"] = None
        if new_target < target:
            state["target"] = new_target
            return "down"
        return None
    state["low_since"] = None
    return None


def pick_spread_slice(
    replicas: list, healthy_slices: "set[str]"
) -> "str | None":
    """Least-populated healthy slice for the next replica (cross-slice
    spread, the serve twin of STRICT_SPREAD_SLICES): one slice
    preemption then takes out at most ceil(n/len(slices)) replicas.
    None when the cluster has no labeled slices."""
    if not healthy_slices:
        return None
    counts = {sid: 0 for sid in healthy_slices}
    for r in replicas:
        sid = r.get("slice")
        if sid in counts:
            counts[sid] += 1
    return min(sorted(counts), key=lambda sid: counts[sid])


class ServeController:
    def __init__(self):
        # (app_name, deployment_name) → deployment record
        self._deployments: dict[tuple, dict] = {}
        # app_name → {"ingress": str, "route_prefix": str, "deployments": [str]}
        self._apps: dict[str, dict] = {}
        # (app, dep) → {router_id: (demand, t)} — handle-reported queued +
        # in-flight requests (reference: handles push queue metrics used
        # by autoscaling_state.py; replica-side ongoing alone misses
        # client-side queuing).
        self._handle_demand: dict[tuple, dict] = {}
        self._shutdown = False
        # Strong refs to fire-and-forget tasks (kills, background replica
        # starts): the loop only weak-refs tasks, so an untracked one can
        # be GC'd before it runs.
        self._bg_tasks: set = set()
        # Head serve-SLO ledger cache ("app/deployment" → public row),
        # refreshed at SERVE_AUTOSCALE_INTERVAL_S inside the control
        # loop — the signal-plane read feeding scale decisions.
        self._slo_cache: dict[str, dict] = {}
        self._slo_last_poll = 0.0
        # (healthy slice ids, node_id → slice_id) from the last
        # cluster_status poll — replica cross-slice spread input.
        self._slices: tuple[set, dict] = (set(), {})
        # Serializes replica-set surgery between the reconcile pass and
        # teardown drains scheduled from the sync RPC thread (both run
        # on the runtime loop, but interleave across awaits).
        from ray_tpu_torch._private import sanitize

        self._drain_lock = sanitize.maybe_async_lock(
            "serve.controller.drain"
        )

    def _spawn_bg(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    # ------------------------------------------------------ deploy API
    def deploy_application(self, app_name: str, spec: dict):
        """spec: {"route_prefix", "ingress", "deployments": [
        {"name", "callable", "init_args", "init_kwargs", "config"}]}"""
        self._apps[app_name] = {
            "ingress": spec["ingress"],
            "route_prefix": spec.get("route_prefix", f"/{app_name}"),
            "deployments": [d["name"] for d in spec["deployments"]],
        }
        for d in spec["deployments"]:
            key = (app_name, d["name"])
            cfg = d["config"]
            auto = cfg.get("autoscaling")
            target = (
                auto["min_replicas"] if auto else cfg.get("num_replicas", 1)
            )
            old = self._deployments.get(key)
            if old is not None and old["replicas"]:
                # Redeploy replaces replicas all-at-once so new code /
                # config actually takes effect (reference: deployment
                # version change triggers replica restart,
                # deployment_state.py).
                asyncio.run_coroutine_threadsafe(
                    self._drain_replicas(dict(old)), core_api._runtime.loop
                )
            now = time.monotonic()
            self._deployments[key] = {
                "name": d["name"],
                "app": app_name,
                "callable": d["callable"],
                "init_args": d["init_args"],
                "init_kwargs": d["init_kwargs"],
                "config": cfg,
                "target": target,
                # replicas: list of dicts {actor_id, addr, node_id,
                # slice, started_at, misses}
                "replicas": [],
                # Scale-down victims mid-drain: {**replica,
                # "drain_deadline": monotonic}. Not routed (absent from
                # get_replicas), killed once idle or past deadline.
                "draining_replicas": [],
                "version": (old["version"] + 1) if old else 0,
                "last_scale_up": now,
                "low_since": None,
                "desired_window": [],
                "status": "UPDATING",
                # Last autoscale decision (surfaced via serve_stats):
                # {"desired", "reason", "ts"}.
                "autoscale": None,
                "reported_target": None,
            }
        return True

    def update_target(
        self, app_name: str, deployment_name: str, target: int
    ) -> int:
        """Operator/bench scaling entry point: set a deployment's
        target replica count directly. Clamped to the autoscaling
        bounds when an autoscaling_config exists (the policy loop keeps
        adjusting from the new value). Scale-down still goes through
        the drain protocol — this is the same target the reconcile
        loop converges on, not a kill."""
        dep = self._deployments.get((app_name, deployment_name))
        if dep is None:
            raise ValueError(
                f"no deployment {deployment_name!r} in app {app_name!r}"
            )
        target = int(target)
        auto = dep["config"].get("autoscaling")
        if auto is not None:
            target = max(
                auto["min_replicas"], min(auto["max_replicas"], target)
            )
        else:
            target = max(0, target)
        dep["target"] = target
        return target

    def delete_application(self, app_name: str):
        """Blocks until replicas are torn down (sync actor methods run on
        the executor thread, so waiting on the loop-side drain is safe)."""
        app = self._apps.pop(app_name, None)
        if app is None:
            return False
        drains = []
        loop = core_api._runtime.loop
        for name in app["deployments"]:
            dep = self._deployments.pop((app_name, name), None)
            self._handle_demand.pop((app_name, name), None)
            if dep:
                dep["target"] = 0
                drains.append(
                    asyncio.run_coroutine_threadsafe(
                        self._drain_replicas(dep), loop
                    )
                )
        for d in drains:
            try:
                d.result(timeout=10)
            except Exception:
                logger.debug(
                    "replica drain failed during app teardown",
                    exc_info=True,
                )
        return True

    async def _drain_replicas(self, dep: dict):
        """App-teardown kill of every replica (deploy replacement or
        delete): unlike scale-down there is nothing to hand traffic to,
        so this is immediate, not the graceful drain protocol."""
        core = core_api._runtime.core
        async with self._drain_lock:
            victims = list(dep["replicas"]) + list(
                dep.get("draining_replicas") or []
            )
            dep["replicas"] = []
            dep["draining_replicas"] = []
        for r in victims:
            try:
                await core.kill_actor(r["actor_id"], r["addr"])
            # tpulint: allow(broad-except reason=drain kill of a replica that already died is the expected race, nothing to handle)
            except Exception:
                pass

    # ------------------------------------------------------- query API
    def get_replicas(self, deployment_name: str, app_name: str):
        dep = self._deployments.get((app_name, deployment_name))
        if dep is None:
            raise ValueError(
                f"no deployment {deployment_name!r} in app {app_name!r}"
            )
        max_ongoing = dep["config"].get("max_ongoing_requests", 5)
        return (
            dep["version"],
            [(r["actor_id"], r["addr"], max_ongoing) for r in dep["replicas"]],
        )

    def record_handle_demand(
        self, deployment_name: str, app_name: str, router_id: str, demand: int
    ):
        self._handle_demand.setdefault((app_name, deployment_name), {})[
            router_id
        ] = (int(demand), time.monotonic())
        return True

    def get_route_table(self):
        """prefix → (app, ingress, request_timeout_s|None). The timeout
        is the ingress deployment's request_timeout_s so the proxy can
        enforce a per-deployment deadline without extra RPCs."""
        table = {}
        for name, app in self._apps.items():
            dep = self._deployments.get((name, app["ingress"]))
            timeout = (
                dep["config"].get("request_timeout_s") if dep else None
            )
            table[app["route_prefix"]] = (name, app["ingress"], timeout)
        return table

    def get_status(self):
        out = {}
        for (app, name), dep in self._deployments.items():
            out.setdefault(app, {})[name] = {
                "status": dep["status"],
                "target": dep["target"],
                "replicas": len(dep["replicas"]),
                "draining": len(dep.get("draining_replicas") or []),
                "autoscale": dep.get("autoscale"),
            }
        return out

    def graceful_shutdown(self):
        self._shutdown = True
        for app in list(self._apps):
            self.delete_application(app)
        return True

    # ---------------------------------------------------- control loop
    async def run_control_loop(self):
        """Reconcile forever (reference: ServeController.run_control_loop).
        Runs as a concurrent async actor task; returns on shutdown."""
        while not self._shutdown:
            try:
                await self._reconcile_once()
            except Exception:
                # Keep the loop alive, but never silently: a reconcile
                # pass that throws every period is an outage in the
                # making (stuck migrations, zombie replicas).
                logger.warning(
                    "serve reconcile pass failed; retrying next period",
                    exc_info=True,
                )
            await asyncio.sleep(_CONTROL_PERIOD_S)
        return True

    async def _cluster_view(self, core) -> tuple[set, set, dict]:
        """(draining node ids, healthy slice ids, node_id→slice_id) —
        one cluster_status poll per reconcile pass, so drain migration
        starts within a control period of the notice and replica
        placement sees the live slice fault domains."""
        try:
            reply = await core.head.call("cluster_status")
        except Exception:
            # Head busy or too old: skip migration/spread this period
            # rather than stall the reconcile.
            logger.debug("cluster_status poll failed", exc_info=True)
            return set(), set(), {}
        draining = set(reply.get("draining") or {})
        node_slice: dict = {}
        healthy: set = set()
        for sid, rec in (reply.get("slices") or {}).items():
            for nid in rec.get("nodes") or []:
                node_slice[nid] = sid
            if rec.get("state") == "healthy":
                healthy.add(sid)
        return draining, healthy, node_slice

    async def _poll_slo(self, core) -> None:
        """Refresh the head serve-SLO ledger cache (attainment, alert,
        request rate per deployment) at SERVE_AUTOSCALE_INTERVAL_S —
        the ledger-read half of the autoscaling loop."""
        from ray_tpu_torch._private import config

        now = time.monotonic()
        if now - self._slo_last_poll < config.get(
            "SERVE_AUTOSCALE_INTERVAL_S"
        ):
            return
        self._slo_last_poll = now
        try:
            reply = await core.head.call("serve_stats")
            self._slo_cache = reply.get("deployments") or {}
        except Exception:
            # A missing ledger only withholds the SLO boost; the demand
            # signal still drives scaling.
            logger.debug("serve_stats poll failed", exc_info=True)

    async def _reconcile_once(self):
        core = core_api._runtime.core
        draining, healthy_slices, node_slice = await self._cluster_view(
            core
        )
        self._slices = (healthy_slices, node_slice)
        await self._poll_slo(core)
        # Evict handle-demand entries from routers that stopped reporting.
        now = time.monotonic()
        for key, routers in list(self._handle_demand.items()):
            for rid, (_d, t) in list(routers.items()):
                if now - t > 10.0:
                    del routers[rid]
            if not routers:
                del self._handle_demand[key]
        for dep in list(self._deployments.values()):
            # 1. Health-check replicas: poll stats, drop the dead.
            stats = await self._poll_stats(core, dep)
            # 2. Autoscale: demand + head SLO ledger → target, through
            # the hysteresis/cooldown policy.
            auto = dep["config"].get("autoscaling")
            if auto is not None and stats is not None:
                self._autoscale(dep, auto, stats)
            # 3. Reconcile count toward target. Starts are background
            # tasks: a deployment whose __init__ jits a model for tens of
            # seconds must not freeze health checks and autoscaling for
            # every other deployment (the stale-record guard in
            # _start_replica makes late completions safe).
            #
            # Drain migration is start-replacement-FIRST: replicas on
            # draining nodes keep serving (they don't count as healthy,
            # so `need` starts their replacements off-node — the head
            # and the draining node itself refuse new placements there)
            # and are retired only once the healthy count reaches
            # target, via the victim ordering below. Requests never see
            # a window with fewer than `target` live replicas.
            n_draining = sum(
                1
                for r in dep["replicas"]
                if r.get("node_id") in draining
            )
            healthy = len(dep["replicas"]) - n_draining
            need = dep["target"] - healthy - dep.get("starting", 0)
            for _ in range(max(0, need)):
                dep["starting"] = dep.get("starting", 0) + 1
                self._spawn_bg(self._start_replica_tracked(core, dep))
            async with self._drain_lock:
                excess = len(dep["replicas"]) - dep["target"]
                if excess > 0:
                    victims = self._scale_down_victims(
                        dep["replicas"], draining, excess
                    )
                    self._begin_drain(dep, victims)
                await self._advance_drains(core, dep)
            dep["status"] = (
                "HEALTHY"
                if len(dep["replicas"]) == dep["target"] and not n_draining
                else "UPDATING"
            )
            self._report_autoscale(core, dep)

    @staticmethod
    def _scale_down_victims(
        replicas: list, draining: set, excess: int
    ) -> list:
        """Scale-down victim order: draining-node replicas first (they
        are already condemned), then the flakiest (highest health-poll
        miss count), then the OLDEST — never the newest/warmest, which
        the previous `replicas[-excess:]` slice used to kill right after
        paying their cold start."""
        ranked = sorted(
            replicas,
            key=lambda r: (
                0 if r.get("node_id") in draining else 1,
                -r.get("misses", 0),
                r.get("started_at", 0.0),
            ),
        )
        return ranked[:excess]

    async def _poll_stats(self, core, dep: dict):
        if not dep["replicas"]:
            return {"num_ongoing_requests": 0}

        async def poll_one(r):
            refs = await core.submit_task(
                "get_stats",
                (),
                {},
                num_returns=1,
                actor=ActorSubmitTarget(r["actor_id"], r["addr"]),
            )
            return (await core.get(refs, timeout=2))[0]

        # Concurrent polls: one hung replica must not stall the control
        # loop for every other deployment.
        results = await asyncio.gather(
            *(poll_one(r) for r in dep["replicas"]), return_exceptions=True
        )
        total_ongoing = 0
        dead = []
        for r, s in zip(list(dep["replicas"]), results):
            if isinstance(s, BaseException):
                # A single missed poll is not death: a replica blocked in
                # a long jit compile (first LLM request) must not be
                # killed mid-request. Three consecutive misses ≈ 3 control
                # periods + timeouts before we declare it gone.
                r["misses"] = r.get("misses", 0) + 1
                if r["misses"] >= 3:
                    dead.append(r)
            else:
                r["misses"] = 0
                total_ongoing += s["num_ongoing_requests"]
        if dead:
            dep["replicas"] = [r for r in dep["replicas"] if r not in dead]
            dep["version"] += 1
            # Kill what we dropped: a replica that stopped answering polls
            # would otherwise keep running (and keep its chips) forever
            # while a replacement starts beside it.
            for r in dead:
                self._spawn_bg(self._kill_quietly(core, r))
        return {"num_ongoing_requests": total_ongoing}

    @staticmethod
    async def _kill_quietly(core, r: dict):
        try:
            await core.kill_actor(r["actor_id"], r["addr"])
        # tpulint: allow(broad-except reason=quiet kill by contract - replica already dead is the common case)
        except Exception:
            pass

    def _autoscale(self, dep: dict, auto: dict, stats: dict):
        """One policy step: demand signal (replica ongoing ∨ handle-
        router queued+in-flight) plus the head ledger's SLO alert →
        desired count → hysteresis/cooldown decision
        (autoscale_decision). The decision and its inputs land in
        dep["autoscale"] for serve_stats/status surfacing."""
        from ray_tpu_torch._private import config

        if not config.get("SERVE_AUTOSCALE"):
            return
        now = time.monotonic()
        reported = self._handle_demand.get((dep["app"], dep["name"]), {})
        handle_demand = sum(
            d for d, t in reported.values() if now - t < 2.0
        )
        ongoing = max(stats["num_ongoing_requests"], handle_demand)
        slo = self._slo_cache.get(f'{dep["app"]}/{dep["name"]}') or {}
        desired = desired_replicas(
            ongoing,
            auto["target_ongoing_requests"],
            auto["min_replicas"],
            auto["max_replicas"],
            slo_alert=bool(slo.get("alert")),
            slo_boost=config.get("SERVE_AUTOSCALE_SLO_BOOST"),
        )
        reason = autoscale_decision(
            dep,
            desired,
            now,
            min_replicas=auto["min_replicas"],
            max_replicas=auto["max_replicas"],
            up_cooldown_s=max(
                auto.get("upscale_delay_s", 0.0) or 0.0,
                config.get("SERVE_AUTOSCALE_UP_COOLDOWN_S"),
            ),
            down_cooldown_s=max(
                auto.get("downscale_delay_s", 0.0) or 0.0,
                config.get("SERVE_AUTOSCALE_DOWN_COOLDOWN_S"),
            ),
            hysteresis=config.get("SERVE_AUTOSCALE_HYSTERESIS"),
        )
        dep["autoscale"] = {
            "desired": desired,
            "ongoing": ongoing,
            "slo_alert": bool(slo.get("alert")),
            "reason": reason or (dep.get("autoscale") or {}).get("reason"),
            "ts": time.time(),
        }

    # ------------------------------------------------ scale-down drain
    def _begin_drain(self, dep: dict, victims: list):
        """Scale-down, step 1 (zero-drop contract): victims leave the
        routed replica list NOW (version bump → routers refresh away),
        are told to refuse new requests (typed refusal covers routers
        holding the stale list), and keep serving their in-flight
        requests until _advance_drains retires them. Caller holds
        _drain_lock."""
        from ray_tpu_torch._private import config

        if not victims:
            return
        timeout = dep["config"].get("drain_timeout_s")
        if timeout is None:
            timeout = config.get("SERVE_DRAIN_TIMEOUT_S")
        now = time.monotonic()
        dep["replicas"] = [
            r for r in dep["replicas"] if r not in victims
        ]
        dep["version"] += 1
        for r in victims:
            r["drain_deadline"] = now + timeout
            dep["draining_replicas"].append(r)
            self._spawn_bg(self._prepare_drain(r))

    async def _prepare_drain(self, r: dict):
        core = core_api._runtime.core
        try:
            refs = await core.submit_task(
                "prepare_drain", (), {}, num_returns=1,
                actor=ActorSubmitTarget(r["actor_id"], r["addr"]),
            )
            await core.get(refs, timeout=5)
        except Exception:
            # Unreachable victim: _advance_drains sees the failed stats
            # poll and retires it as "dead" — the drain still converges.
            logger.debug(
                "prepare_drain failed; replica will be reaped",
                exc_info=True,
            )

    async def _advance_drains(self, core, dep: dict):
        """Scale-down, step 2: retire each draining replica once its
        in-flight count hits zero (clean), its drain deadline passes
        (timeout), or it stops answering (dead). Caller holds
        _drain_lock."""
        pending = dep.get("draining_replicas") or []
        if not pending:
            return
        now = time.monotonic()
        done: list = []
        for r in pending:
            outcome = None
            try:
                refs = await core.submit_task(
                    "get_stats", (), {}, num_returns=1,
                    actor=ActorSubmitTarget(r["actor_id"], r["addr"]),
                )
                stats = (await core.get(refs, timeout=2))[0]
                if stats["num_ongoing_requests"] <= 0:
                    outcome = "clean"
                elif now >= r["drain_deadline"]:
                    outcome = "timeout"
            # tpulint: allow(broad-except reason=a draining replica that stopped answering is retired as dead; the drain must converge, not diagnose)
            except Exception:
                outcome = "dead"
            if outcome is not None:
                done.append((r, outcome))
        for r, outcome in done:
            dep["draining_replicas"].remove(r)
            self._spawn_bg(self._kill_quietly(core, r))
            if outcome == "timeout":
                logger.warning(
                    "serve %s/%s: draining replica exceeded its "
                    "drain timeout with requests still in flight; "
                    "killing it",
                    dep["app"], dep["name"],
                )
            from ray_tpu_torch.serve import telemetry as stel

            if stel.enabled():
                stel.DRAINED_REPLICAS.inc(
                    tags={"app": dep["app"], "deployment": dep["name"],
                          "outcome": outcome},
                )

    def _report_autoscale(self, core, dep: dict):
        """Push this deployment's target (and last decision) to the
        head — serve_stats' "autoscale" block and the head-owned
        ray_tpu_serve_target_replicas gauge — and mirror it on the
        controller-local gauge. Sent on change only; the head keeps the
        last word."""
        if dep.get("reported_target") == (
            dep["target"], len(dep["replicas"]),
        ):
            return
        dep["reported_target"] = (dep["target"], len(dep["replicas"]))
        from ray_tpu_torch.serve import telemetry as stel

        if stel.enabled():
            stel.TARGET_REPLICAS.set(
                dep["target"],
                tags={"app": dep["app"], "deployment": dep["name"]},
            )
        auto = dep.get("autoscale") or {}
        self._spawn_bg(
            self._send_autoscale_report(
                core,
                app=dep["app"],
                deployment=dep["name"],
                target=dep["target"],
                replicas=len(dep["replicas"]),
                draining=len(dep.get("draining_replicas") or []),
                desired=auto.get("desired"),
                reason=auto.get("reason"),
            )
        )

    @staticmethod
    async def _send_autoscale_report(core, **kw):
        try:
            await core.head.call("serve_autoscale_report", **kw)
        except Exception:
            # Old head / head mid-restart: the gauge still updated
            # locally; the next change retries.
            logger.debug("serve_autoscale_report failed", exc_info=True)

    async def _start_replica_tracked(self, core, dep: dict):
        try:
            await self._start_replica(core, dep)
        except Exception:
            # e.g. no feasible node; the reconcile loop will retry next
            # period, so log rather than let asyncio print "Task
            # exception was never retrieved".
            logger.debug("replica start failed; will retry",
                         exc_info=True)
        finally:
            dep["starting"] = max(0, dep.get("starting", 0) - 1)

    async def _start_replica(self, core, dep: dict):
        cfg = dep["config"]
        actor_opts = cfg.get("ray_actor_options", {})
        resources = dict(actor_opts.get("resources", {}))
        if "num_cpus" in actor_opts:
            resources["CPU"] = float(actor_opts["num_cpus"])
        if "num_gpus" in actor_opts:
            resources["GPU"] = float(actor_opts["num_gpus"])
        create_kwargs = dict(
            resources=resources or {"CPU": 0.1},
            max_concurrency=max(
                2 * cfg.get("max_ongoing_requests", 5), 16
            ),
        )
        # Cross-slice spread: when the cluster labels slices, pin the
        # new replica to the healthy slice currently holding the fewest
        # of this deployment's replicas (the serve twin of
        # STRICT_SPREAD_SLICES — one slice preemption cannot take out
        # every replica). Falls back to unconstrained placement when
        # the chosen slice cannot take the lease: availability beats
        # spread.
        healthy_slices, _node_slice = self._slices
        spread = pick_spread_slice(
            dep["replicas"] + (dep.get("draining_replicas") or []),
            healthy_slices,
        )
        args = (
            dep["name"],
            dep["callable"],
            dep["init_args"],
            dep["init_kwargs"],
            cfg.get("user_config"),
        )
        if spread is not None:
            try:
                actor_id, addr = await core.create_actor(
                    ReplicaActor, args, {},
                    scheduling={"labels_hard": {"slice": spread}},
                    **create_kwargs,
                )
            # tpulint: allow(broad-except reason=spread placement is best-effort; the unconstrained fallback below keeps the deployment available)
            except Exception:
                logger.debug(
                    "cross-slice replica placement on slice %r failed; "
                    "falling back to unconstrained placement",
                    spread, exc_info=True,
                )
                spread = None
        if spread is None:
            actor_id, addr = await core.create_actor(
                ReplicaActor, args, {}, **create_kwargs,
            )
        # Which node hosts this replica? The head's actor registry knows
        # — needed so drain migration and victim selection can reason
        # per-node.
        node_id = None
        try:
            info = await core.head.call("get_actor", actor_id=actor_id)
            if info.get("ok"):
                node_id = info.get("node_id")
        except Exception:
            logger.debug("actor node lookup failed; node_id unknown",
                         exc_info=True)
        key = (dep["app"], dep["name"])
        if self._deployments.get(key) is not dep:
            # The deployment was redeployed or deleted while this replica
            # was starting; appending to the stale record would orphan it.
            await self._kill_quietly(core, {"actor_id": actor_id, "addr": addr})
            return
        dep["replicas"].append(
            {
                "actor_id": actor_id,
                "addr": addr,
                "node_id": node_id,
                "slice": self._slices[1].get(node_id),
                "started_at": time.monotonic(),
            }
        )
        dep["version"] += 1
