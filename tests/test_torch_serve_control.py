"""Serve control plane: SLO-driven autoscaling, zero-drop drains, and
replica-kill survival.

The robustness twin of the train stack's elastic tests: the signal
plane (queue depth, TTFT attainment, the head SLO ledger) now DRIVES
actions — replica counts track load without flapping, scale-down
retires replicas through a drain protocol that never drops a request,
and a SIGKILLed replica surfaces as a typed, re-routed failure instead
of a hang.

The JAX package's serve control tests (tests/test_serve_control.py)
on the port's runtime and serve package, every case kept. The drain
case reads the head's serve ledger through util/state.py's serve_stats,
as the JAX package's does.
"""

import asyncio
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.controller import (
    autoscale_decision,
    desired_replicas,
    pick_spread_slice,
)
from ray_tpu_torch.serve.handle import _Breaker


# ---------------------------------------------------- breaker transitions
def test_breaker_open_half_open_close_transitions():
    """Closed → open after N consecutive failures, open → half-open
    after the reset window (single probe), probe success closes, probe
    failure re-opens."""
    br = _Breaker()
    reset_s = 2.0
    assert br.state(0.0, reset_s) == "closed"
    br.record_failure(0.0, threshold=3)
    br.record_failure(0.1, threshold=3)
    assert br.state(0.2, reset_s) == "closed"  # below threshold
    br.record_failure(0.2, threshold=3)
    assert br.state(0.3, reset_s) == "open"
    assert not br.allow(0.3, reset_s)
    assert not br.routable(0.3, reset_s)
    # Reset window elapses → half-open, exactly one probe admitted.
    assert br.state(2.5, reset_s) == "half_open"
    assert br.routable(2.5, reset_s)
    assert br.allow(2.5, reset_s)
    assert not br.allow(2.6, reset_s)  # probe already in flight
    # Probe failure → re-open (a fresh reset window).
    br.record_failure(2.7, threshold=3)
    assert br.state(2.8, reset_s) == "open"
    assert br.state(5.0, reset_s) == "half_open"
    assert br.allow(5.0, reset_s)
    # Probe success → closed, failures forgotten.
    br.record_success()
    assert br.state(5.1, reset_s) == "closed"
    assert br.allow(5.1, reset_s)
    br.record_failure(5.2, threshold=3)
    assert br.state(5.3, reset_s) == "closed"  # count restarted at 0


# --------------------------------------------------- autoscale decisions
def _decide(state, desired, now, **kw):
    defaults = dict(
        min_replicas=1, max_replicas=8,
        up_cooldown_s=0.0, down_cooldown_s=5.0, hysteresis=0.1,
    )
    defaults.update(kw)
    return autoscale_decision(state, desired, now, **defaults)


def test_autoscale_no_flap_under_oscillating_load():
    """Desired oscillating above/below target every second never moves
    the target: scale-down requires desired to stay low CONTINUOUSLY
    for the down cooldown, and drops only to the window max."""
    state = {"target": 4, "last_scale_up": -100.0}
    changes = []
    for t in range(20):
        desired = 2 if t % 2 == 0 else 4
        reason = _decide(state, desired, float(t))
        if reason:
            changes.append((t, reason, state["target"]))
    assert state["target"] == 4
    assert changes == []


def test_autoscale_tracks_sustained_load_down_and_up():
    state = {"target": 4, "last_scale_up": -100.0}
    # Sustained low demand: scales down once, after the full cooldown.
    reasons = [_decide(state, 1, float(t)) for t in range(10)]
    assert state["target"] == 1
    assert reasons.count("down") == 1
    # The down move waited out the 5s window (first low sample at t=0
    # arms the timer; the move lands at t>=5).
    assert reasons.index("down") >= 5
    # Demand returns: immediate scale-up (up cooldown 0).
    assert _decide(state, 6, 20.0) == "up"
    assert state["target"] == 6


def test_autoscale_down_uses_window_max_not_trough():
    """A dip to 1 inside a window that also saw 3 scales down to 3,
    not 1 — troughs never set the target."""
    state = {"target": 6, "last_scale_up": -100.0}
    seq = [3, 1, 3, 1, 3, 3, 3, 3]
    for t, desired in enumerate(seq):
        _decide(state, desired, float(t))
    assert state["target"] == 3


def test_autoscale_hysteresis_dead_band():
    """A desired within hysteresis*target of target is noise, not a
    scale signal (matters at fleet sizes where ±1 is jitter)."""
    state = {"target": 20, "last_scale_up": -100.0}
    for t in range(12):
        assert _decide(
            state, 19, float(t), max_replicas=64, hysteresis=0.1
        ) is None
    assert state["target"] == 20
    # Outside the band the same demand drop does scale down.
    state2 = {"target": 20, "last_scale_up": -100.0}
    for t in range(12):
        _decide(state2, 10, float(t), max_replicas=64, hysteresis=0.1)
    assert state2["target"] == 10


def test_desired_replicas_demand_and_slo_boost():
    assert desired_replicas(0, 2.0, 1, 8) == 1
    assert desired_replicas(5, 2.0, 1, 8) == 3  # ceil(5/2)
    assert desired_replicas(100, 2.0, 1, 8) == 8  # capped
    # SLO alert leans one above demand, still capped.
    assert desired_replicas(5, 2.0, 1, 8, slo_alert=True) == 4
    assert desired_replicas(100, 2.0, 1, 8, slo_alert=True) == 8
    assert desired_replicas(5, 2.0, 1, 8, slo_alert=True,
                            slo_boost=False) == 3


# ------------------------------------------------- cross-slice placement
def test_pick_spread_slice_least_populated():
    replicas = [{"slice": "s0"}, {"slice": "s0"}, {"slice": "s1"}]
    assert pick_spread_slice(replicas, {"s0", "s1", "s2"}) == "s2"
    assert pick_spread_slice(replicas, {"s0", "s1"}) == "s1"
    # No labeled slices → no constraint.
    assert pick_spread_slice(replicas, set()) is None
    # Replicas on unknown/dead slices don't skew the counts.
    assert pick_spread_slice(
        [{"slice": None}, {"slice": "dead"}], {"s0"}
    ) == "s0"


# ---------------------------------------- slice-aware elastic re-sizing
def test_elastic_policy_counts_whole_surviving_slices():
    """A slice with a draining/dead sibling contributes ZERO bundles to
    the next attempt's size — the slice dies as a unit, so its stray
    healthy hosts must not inflate the attempt."""
    from ray_tpu_torch.train.trainer import ElasticScalingPolicy, ScalingConfig

    policy = ElasticScalingPolicy(min_workers=1)
    scaling = ScalingConfig(num_workers=16)
    cluster_free = [
        {"CPU": 4.0, "_slice": "s0", "_slice_whole": True},
        {"CPU": 4.0, "_slice": "s0", "_slice_whole": True},
        {"CPU": 4.0, "_slice": "s1", "_slice_whole": False},
        {"CPU": 4.0, "_slice": "s1", "_slice_whole": False},
        {"CPU": 4.0},  # unlabeled: its own singleton fault domain
    ]
    # s0 whole (8 bundles) + unlabeled (4); s1 condemned (0).
    assert policy.workers_for_attempt(scaling, 1, cluster_free) == 12
    # All slices whole → every bundle counts.
    for row in cluster_free:
        if "_slice" in row:
            row["_slice_whole"] = True
    assert policy.workers_for_attempt(scaling, 1, cluster_free) == 16


# ------------------------------------------------ head ledger additions
def test_autoscale_report_folds_into_serve_stats_and_gauge():
    from ray_tpu_torch.runtime.head import HeadService

    head = HeadService(journal_path="off")
    asyncio.run(
        head._on_serve_autoscale_report(
            None, app="a", deployment="d", target=3, replicas=2,
            draining=1, desired=3, reason="up",
        )
    )
    out = asyncio.run(head._on_serve_stats(None))
    row = out["deployments"]["a/d"]
    assert row["autoscale"]["target"] == 3
    assert row["autoscale"]["draining"] == 1
    assert row["autoscale"]["reason"] == "up"
    snap = head._serve_metrics_snapshot()
    assert snap["ray_tpu_serve_target_replicas"]["series"][
        'deployment="a/d"'
    ] == 3.0
    # An ingress span for the same deployment merges ledger + autoscale
    # in one row, now with the request-rate signal.
    head._serve_request_event(
        {"app": "a", "deployment": "d", "ts": 100.0, "dur": 0.05,
         "status": 200}
    )
    row = asyncio.run(head._on_serve_stats(None))["deployments"]["a/d"]
    assert row["requests"] == 1
    assert row["request_rate_per_s"] > 0
    assert row["autoscale"]["target"] == 3


def test_host_sync_exposed_in_goodput_ledger():
    """host_sync_exposed_s on rank-0 step spans accumulates in the head
    goodput ledger next to comm_exposed_s."""
    from ray_tpu_torch.runtime.head import HeadService

    head = HeadService(journal_path="off")
    t = 1000.0
    for _ in range(4):
        head._train_step_event(
            {
                "train_job": "job",
                "train_rank": 0,
                "train_attempt": 0,
                "ts": t,
                "dur": 1.0,
                "phases": {},
                "comm_exposed_s": 0.1,
                "host_sync_exposed_s": 0.25,
            }
        )
        t += 1.0
    pub = head._train_job_public(head.train_runs["job"])
    assert pub["host_sync_exposed_s"] == pytest.approx(1.0)
    assert pub["host_sync_exposed_ratio"] == pytest.approx(0.25)
    assert pub["comm_exposed_ratio"] == pytest.approx(0.1)


# ----------------------------------------------------- cluster fixtures
@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=16)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


# ------------------------------------------------ zero-drop scale-down
def test_scale_down_drain_zero_dropped_requests(serve_cluster):
    """serve.scale 3→1 under live load: victims stop accepting (typed
    refusal re-routes), finish their in-flight requests, then retire —
    the client sees every request succeed."""

    @serve.deployment(num_replicas=3, max_ongoing_requests=2)
    def slow(x):
        time.sleep(0.05)
        return x * 2

    handle = serve.run(slow.bind(), name="zdrop_app")
    assert handle.remote(1).result(timeout=60) == 2

    errors: list = []
    results: list = []

    def traffic():
        for i in range(50):
            try:
                results.append(handle.remote(i).result(timeout=30))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=traffic, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.4)  # mid-load
    assert serve.scale("slow", 1, app_name="zdrop_app") == 1
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "traffic hung"
    assert not errors, errors[:3]
    assert sorted(results) == sorted(
        [i * 2 for i in range(50)] * 2
    )
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = serve.status()["zdrop_app"]["slow"]
        if st["replicas"] == 1 and st["draining"] == 0:
            break
        time.sleep(0.25)
    st = serve.status()["zdrop_app"]["slow"]
    assert st["replicas"] == 1 and st["draining"] == 0
    # The controller reported the new target to the head ledger.
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + 15
    asc = None
    while time.monotonic() < deadline:
        asc = (
            state.serve_stats()["deployments"]
            .get("zdrop_app/slow", {})
            .get("autoscale")
        )
        if asc and asc["target"] == 1 and asc["replicas"] == 1:
            break
        time.sleep(0.3)
    assert asc and asc["target"] == 1


# ---------------------------------------- all-replicas-down → 503 path
def test_scale_to_zero_503_retry_after_then_recovery(serve_cluster):
    """With zero routable replicas the proxy answers 503 with a
    Retry-After header (typed NoReplicaAvailableError, never a hang);
    scaling back up restores service on the same handle/proxy."""
    import urllib.error
    import urllib.request

    @serve.deployment
    def echo503(request):
        return {"ok": True}

    serve.run(echo503.bind(), name="app503", route_prefix="/app503")
    port = serve.start_http()
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/app503", data=b"{}", timeout=30
    ) as resp:
        assert resp.status == 200
    serve.scale("echo503", 0, app_name="app503")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = serve.status()["app503"]["echo503"]
        if st["replicas"] == 0 and st["draining"] == 0:
            break
        time.sleep(0.2)
    with pytest.raises(urllib.error.HTTPError) as ei:
        # SERVE_UNAVAILABLE_TIMEOUT_S (5s) elapses, then the typed 503.
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/app503", data=b"{}", timeout=30
        )
    assert ei.value.code == 503
    assert int(ei.value.headers["Retry-After"]) >= 1
    serve.scale("echo503", 1, app_name="app503")
    deadline = time.monotonic() + 30
    ok = False
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/app503", data=b"{}", timeout=30
            ) as resp:
                ok = resp.status == 200
                break
        except urllib.error.HTTPError:
            time.sleep(0.25)
    assert ok, "service did not recover after scale-up"


# ------------------------------------------------- replica-kill chaos
@pytest.mark.chaos
def test_replica_sigkill_unary_requests_survive(serve_cluster):
    """SIGKILL one of two replicas under unary load: every request
    succeeds (typed death → capped re-dispatch onto the survivor) and
    the controller restores the target count."""
    from ray_tpu_torch._private.test_utils import kill_one_replica

    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    def unary(x):
        time.sleep(0.03)
        return x + 100

    handle = serve.run(unary.bind(), name="kchaos_u")
    assert handle.remote(1).result(timeout=60) == 101

    errors: list = []
    results: list = []

    def traffic():
        for i in range(40):
            try:
                results.append(handle.remote(i).result(timeout=30))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    time.sleep(0.3)
    killed = kill_one_replica("unary", "kchaos_u")
    assert killed
    t.join(timeout=50)
    assert not t.is_alive(), "unary traffic hung after replica SIGKILL"
    assert not errors, errors[:3]
    assert sorted(results) == [i + 100 for i in range(40)]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if serve.status()["kchaos_u"]["unary"]["replicas"] == 2:
            break
        time.sleep(0.25)
    assert serve.status()["kchaos_u"]["unary"]["replicas"] == 2


@pytest.mark.chaos
def test_replica_sigkill_midstream_typed_failure_no_hang(serve_cluster):
    """SIGKILL one of two replicas while streams are in flight: streams
    that had not yielded re-route to the survivor and complete; streams
    already yielding fail with a TYPED error (never a hang — the chaos
    wall-clock guard enforces it); fresh streams succeed."""
    from ray_tpu_torch._private.test_utils import kill_one_replica
    from ray_tpu_torch.exceptions import (
        ActorDiedError,
        RayTaskError,
        WorkerDiedError,
    )
    from ray_tpu_torch._private import rpc

    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    def streamer(n):
        for i in range(n):
            time.sleep(0.05)
            yield i

    handle = serve.run(streamer.bind(), name="kchaos_s")
    warm = list(handle.options(stream=True).remote(3))
    assert warm == [0, 1, 2]

    n_items = 30
    outcomes: list = []  # ("ok", items) | ("error", exc)

    def consume():
        items = []
        try:
            for item in handle.options(stream=True).remote(n_items):
                items.append(item)
            outcomes.append(("ok", items))
        except Exception as e:  # noqa: BLE001
            outcomes.append(("error", e))

    threads = [threading.Thread(target=consume, daemon=True)
               for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.4)  # streams are mid-flight on both replicas
    kill_one_replica("streamer", "kchaos_s")
    for t in threads:
        t.join(timeout=45)
    assert not any(t.is_alive() for t in threads), \
        "a stream HUNG after replica SIGKILL"
    assert len(outcomes) == 6
    oks = [o for o in outcomes if o[0] == "ok"]
    errs = [o for o in outcomes if o[0] == "error"]
    # Completed streams are complete — no silent truncation.
    for _tag, items in oks:
        assert items == list(range(n_items))
    # Failed streams failed TYPED (death/conn loss surfaced, not a
    # mystery) — and at least the survivor's streams completed.
    for _tag, e in errs:
        assert isinstance(
            e,
            (ActorDiedError, WorkerDiedError, RayTaskError,
             rpc.ConnectionLost, rpc.RpcError, StopIteration),
        ), f"untyped stream failure: {type(e).__name__}: {e}"
    assert oks, "no stream survived the kill"
    # Service recovered: a fresh stream completes on the first try.
    assert list(handle.options(stream=True).remote(4)) == [0, 1, 2, 3]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if serve.status()["kchaos_s"]["streamer"]["replicas"] == 2:
            break
        time.sleep(0.25)
    assert serve.status()["kchaos_s"]["streamer"]["replicas"] == 2
