"""The port's autoscaler held to the JAX package's: bin-packing on the same
inputs, the same provider and head calls over one scripted sequence of
head readings, and the live cases of tests/test_autoscaler.py (with
tests/test_slice_domains.py's slice-unit replacement and
tests/test_observability.py's chronic straggler) on the port's runtime.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    FakeNodeProvider,
    NodeTypeConfig,
    fit_demand,
)
from torch_runtime_util import start_cluster, stop_cluster


# ------------------------------------------------------------ fit_demand
def test_fit_demand_uses_headroom():
    to_add = fit_demand(
        demand=[{"CPU": 1}, {"CPU": 1}],
        node_types={"cpu": {"resources": {"CPU": 4}, "max_workers": 5}},
        existing_counts={},
        free_by_node=[{"CPU": 2}],
    )
    assert to_add == {}  # fits in existing headroom


def test_fit_demand_packs_new_nodes():
    to_add = fit_demand(
        demand=[{"CPU": 2} for _ in range(4)],
        node_types={"cpu4": {"resources": {"CPU": 4}, "max_workers": 5}},
        existing_counts={},
        free_by_node=[],
    )
    assert to_add == {"cpu4": 2}  # 4×2 CPU packs into 2×4-CPU nodes


def test_fit_demand_prefers_cheapest_feasible():
    to_add = fit_demand(
        demand=[{"GPU": 1}],
        node_types={
            "cpu": {"resources": {"CPU": 8}, "max_workers": 5},
            "h100x1": {"resources": {"CPU": 4, "GPU": 1}, "max_workers": 2},
            "h100x8": {"resources": {"CPU": 8, "GPU": 8}, "max_workers": 2},
        },
        existing_counts={},
        free_by_node=[],
    )
    assert to_add == {"h100x1": 1}


def test_fit_demand_respects_max_workers():
    to_add = fit_demand(
        demand=[{"CPU": 4} for _ in range(5)],
        node_types={"cpu4": {"resources": {"CPU": 4}, "max_workers": 2}},
        existing_counts={"cpu4": 1},
        free_by_node=[],
    )
    assert to_add == {"cpu4": 1}  # cap: 1 existing + 1 new


def _random_fit_inputs(seed):
    """Demands, node types, counts and headroom drawn from ``seed``:
    quarter-unit amounts of CPU, GPU and one custom resource."""
    rng = np.random.default_rng(seed)
    keys = ["CPU", "GPU", "WIDGET"]

    def shape(lo, hi):
        chosen = rng.choice(keys, size=rng.integers(1, 4), replace=False)
        return {str(k): float(rng.integers(lo, hi)) / 4 for k in chosen}

    node_types = {
        f"t{i}": {"resources": shape(4, 65),
                  "max_workers": int(rng.integers(0, 5))}
        for i in range(int(rng.integers(1, 5)))
    }
    demand = [shape(1, 33) for _ in range(int(rng.integers(0, 16)))]
    counts = {name: int(rng.integers(0, 3)) for name in node_types
              if rng.random() < 0.5}
    free = [shape(0, 33) for _ in range(int(rng.integers(0, 4)))]
    return demand, node_types, counts, free


@settings(max_examples=200, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**32 - 1))
def test_fit_demand_equals_the_reference(seed):
    from ray_tpu.autoscaler import fit_demand as ref_fit_demand

    demand, node_types, counts, free = _random_fit_inputs(seed)
    want = ref_fit_demand(demand, node_types, counts, free)
    assert fit_demand(demand, node_types, counts, free) == want


# ------------------------------------------------- decision-trace parity
class _RecordingProvider:
    """Records every provider call in ``trace``; ids are p0, p1, ... in
    launch order, and ``registered`` maps them to runtime node ids."""

    def __init__(self, trace, registered):
        self.trace = trace
        self.registered = registered
        self.live: dict[str, str] = {}
        self.launched = 0

    def create_node(self, node_type, resources):
        pid = f"p{self.launched}"
        self.launched += 1
        self.trace.append(("create_node", node_type, dict(resources)))
        self.live[pid] = node_type
        return pid

    def terminate_node(self, pid):
        self.trace.append(("terminate_node", pid))
        self.live.pop(pid, None)

    def terminate_nodes(self, pids):
        self.trace.append(("terminate_nodes", sorted(pids)))
        for pid in pids:
            self.live.pop(pid, None)

    def non_terminated_nodes(self):
        return dict(self.live)

    def runtime_node_id(self, pid):
        return self.registered.get(pid)


def _node(total, available, slice_label=None, pending=()):
    return {"resources": dict(total), "available": dict(available),
            "labels": {"slice": slice_label} if slice_label else {},
            "pending": list(pending)}


GPU1 = {"CPU": 2.0, "GPU": 1.0}
GPU8 = {"CPU": 8.0, "GPU": 8.0}
HEAD = _node({"CPU": 4.0}, {"CPU": 4.0})


def _script():
    """(clock offset s, cluster_status, straggler counts, registrations
    that happen before the tick) for each tick of the sequence."""
    far = 1e9  # a drain deadline beyond the sequence
    busy1 = {"CPU": 2.0, "GPU": 0.0}
    busy8 = {"CPU": 8.0, "GPU": 0.0}
    slice_nodes = {"n1": _node(GPU8, busy8, "s0"),
                   "n2": _node(GPU8, busy8, "s0")}
    ticks = []
    # 1: two 8-GPU and two 1-GPU demands; the min-worker node p0 is still
    # booting (credited): one GPU8 slice of two VMs and one more GPU1.
    ticks.append((1.0, {"nodes": {"head": HEAD}, "unschedulable": [
        {"GPU": 8.0}, {"GPU": 8.0}, {"GPU": 1.0}, {"GPU": 1.0}]}, {}, {}))
    # 2: all registered and busy.
    registered = {"p0": "n0", "p1": "n1", "p2": "n2", "p3": "n3"}
    ticks.append((2.0, {"nodes": {"head": HEAD,
                                  "n0": _node(GPU1, busy1),
                                  "n3": _node(GPU1, busy1),
                                  **slice_nodes}}, {}, registered))
    # 3-4: the GPU1 nodes go idle and one is reaped (min_workers=1).
    idle = {"head": HEAD, "n0": _node(GPU1, GPU1), "n3": _node(GPU1, GPU1),
            **slice_nodes}
    ticks.append((3.0, {"nodes": idle}, {}, {}))
    ticks.append((10.0, {"nodes": idle}, {}, {}))
    # 5: the slice s0 drains; n1 is empty, n2 still busy: one
    # replacement launch (p4), no teardown yet.
    draining = {nid: {"reason": "preempt", "deadline_ts": far}
                for nid in ("n1", "n2")}
    one_gpu1 = {k: v for k, v in idle.items() if k != "n0"}
    half = dict(one_gpu1, n1=_node(GPU8, GPU8, "s0"))
    ticks.append((11.0, {"nodes": half, "draining": draining}, {}, {}))
    # 6: n2 empties too: the unit reaps in ONE terminate_nodes call.
    empty = dict(half, n2=_node(GPU8, GPU8, "s0"))
    ticks.append((12.0, {"nodes": empty, "draining": draining}, {}, {}))
    # 7: the replacement registered as n4, busy, and a chronic straggler
    # (25 >= 20): drained through the head and replaced (p5).
    after = {k: v for k, v in one_gpu1.items() if k not in ("n1", "n2")}
    after["n4"] = _node(GPU8, busy8)
    ticks.append((13.0, {"nodes": after}, {"n4": 25.0}, {"p4": "n4"}))
    # 8: the head lists n4 draining, now empty: it is torn down; p5
    # registers as n5, busy.
    after8 = dict(after, n4=_node(GPU8, GPU8), n5=_node(GPU8, busy8))
    ticks.append((14.0, {"nodes": after8, "draining": {
        "n4": {"reason": "chronic straggler", "deadline_ts": far}}},
        {"n4": 25.0}, {"p5": "n5"}))
    return ticks


def _drive(module, scaler_cls, config_cls, monkeypatch, base_mono):
    """Drive one package's Autoscaler over ``_script()`` on a fake clock
    from ``base_mono`` (and a fixed wall clock); return (provider and
    drain calls, last_status of every tick)."""
    trace, registered = [], {}
    base_wall = 1.7e9
    clock = {"t": 0.0}
    monkeypatch.setattr(module, "time", SimpleNamespace(
        monotonic=lambda: base_mono + clock["t"],
        time=lambda: base_wall + clock["t"]))
    provider = _RecordingProvider(trace, registered)
    scaler = scaler_cls(
        provider,
        {"gpu1": config_cls(resources=GPU1, min_workers=1, max_workers=4),
         "gpu8": config_cls(resources=GPU8, max_workers=3)},
        idle_timeout_s=5.0, interval_s=3600.0, boot_grace_s=600.0,
        straggler_threshold=20,
    )
    step = {}
    scaler._cluster_status = lambda: step["status"]
    scaler._straggler_node_counts = lambda: step["stragglers"]

    def drain(node_id, reason):
        trace.append(("drain_node", node_id, reason))
        return True

    scaler._drain_node_via_head = drain
    scaler.start()  # adopts nothing, launches the min worker
    statuses = []
    try:
        for t, status, stragglers, regs in _script():
            clock["t"] = t
            registered.update(regs)
            step.update(status=status, stragglers=stragglers)
            statuses.append(scaler.update())
    finally:
        scaler.stop()
    return trace, statuses


def test_decision_trace_equals_the_reference(monkeypatch):
    """Scale-up, min workers, idle reap, a draining slice replaced once
    and torn down as one call, a partially drained slice that waits, and
    a chronic straggler drained and replaced: the same calls in the same
    order, and the same status every tick."""
    import ray_tpu.autoscaler.autoscaler as ref_module
    import ray_tpu_torch.autoscaler.autoscaler as module

    base = time.monotonic()
    want, want_status = _drive(ref_module, ref_module.Autoscaler,
                               ref_module.NodeTypeConfig, monkeypatch, base)
    got, got_status = _drive(module, module.Autoscaler,
                             module.NodeTypeConfig, monkeypatch, base)
    assert got == want
    assert got_status == want_status
    assert want == [
        ("create_node", "gpu1", GPU1),  # min_workers at start
        ("create_node", "gpu8", GPU8),
        ("create_node", "gpu8", GPU8),
        ("create_node", "gpu1", GPU1),
        ("terminate_node", "p0"),  # idle past 5 s, above min_workers
        ("create_node", "gpu8", GPU8),  # one launch for the slice s0
        ("terminate_nodes", ["p1", "p2"]),  # the whole unit, once
        ("drain_node", "n4", "chronic straggler"),
        ("create_node", "gpu8", GPU8),  # the straggler's replacement
        ("terminate_nodes", ["p4"]),
    ]


# ------------------------------------------------------------ live cases
@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=2)
    yield info
    stop_cluster(info)


def test_autoscaler_scales_up_for_infeasible_task(cluster):
    """A task needing a resource no node has blocks, the autoscaler adds
    a node of the right type, and the task completes (lease spillback
    finds the new node)."""
    provider = FakeNodeProvider()
    autoscaler = Autoscaler(
        provider,
        {"gpuish": NodeTypeConfig(resources={"CPU": 2, "WIDGET": 4})},
        idle_timeout_s=3600,
        interval_s=0.25,
    )
    autoscaler.start()
    try:
        @ray_tpu_torch.remote(resources={"WIDGET": 1})
        def widget_task():
            return "made a widget"

        ref = widget_task.remote()
        assert ray_tpu_torch.get(ref, timeout=60) == "made a widget"
        assert len(provider.non_terminated_nodes()) == 1
        assert autoscaler.last_status["tracked"]
    finally:
        autoscaler.stop()
        for pid in list(provider.non_terminated_nodes()):
            provider.terminate_node(pid)


def test_actor_spills_to_scaled_up_node(cluster):
    """Actor creation (not just tasks) rides the same spillback path, and
    the actor runs on the node the provider maps its id to."""
    provider = FakeNodeProvider()
    autoscaler = Autoscaler(
        provider,
        {"gadget": NodeTypeConfig(resources={"CPU": 2, "GADGET": 2})},
        idle_timeout_s=3600,
        interval_s=0.25,
    )
    autoscaler.start()
    try:
        @ray_tpu_torch.remote(resources={"GADGET": 1})
        class GadgetActor:
            def ping(self):
                return "pong"

            def node_addr(self):
                import os

                return os.environ["RAY_TPU_NODE_ADDR"]

        a = GadgetActor.remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
        from ray_tpu_torch.util import state

        (pid,) = provider.non_terminated_nodes()
        addrs = {n["node_id"]: n["addr"] for n in state.list_nodes()}
        assert ray_tpu_torch.get(a.node_addr.remote(), timeout=60) == (
            addrs[provider.runtime_node_id(pid)])
        ray_tpu_torch.kill(a)
    finally:
        autoscaler.stop()
        for pid in list(provider.non_terminated_nodes()):
            provider.terminate_node(pid)


def test_autoscaler_min_workers_and_idle_termination(cluster):
    provider = FakeNodeProvider()
    autoscaler = Autoscaler(
        provider,
        {
            "extra": NodeTypeConfig(
                resources={"CPU": 1, "EXTRA": 1}, min_workers=1, max_workers=3
            )
        },
        idle_timeout_s=1.0,
        interval_s=0.2,
    )
    autoscaler.start()
    try:
        time.sleep(0.5)
        assert len(provider.non_terminated_nodes()) == 1  # min_workers

        # Drive demand above min: two concurrent EXTRA tasks.
        @ray_tpu_torch.remote(resources={"EXTRA": 1})
        def hold(t):
            time.sleep(t)
            return 1

        refs = [hold.remote(2.0) for _ in range(2)]
        assert ray_tpu_torch.get(refs, timeout=60) == [1, 1]
        # Idle nodes above min_workers are reaped after the timeout.
        deadline = time.time() + 20
        while time.time() < deadline:
            if len(provider.non_terminated_nodes()) == 1:
                break
            time.sleep(0.3)
        assert len(provider.non_terminated_nodes()) == 1
    finally:
        autoscaler.stop()
        for pid in list(provider.non_terminated_nodes()):
            provider.terminate_node(pid)


def test_autoscaler_replaces_draining_slice_as_one_unit():
    """Two draining hosts sharing a slice label buy exactly ONE provider
    launch (a unit is provisioned whole); unlabeled draining nodes still
    replace per node."""
    created = []

    class Provider:
        def create_node(self, node_type, resources):
            created.append(node_type)
            return f"p{len(created)}"

        def terminate_node(self, pid):
            pass

        def runtime_node_id(self, pid):
            return None

        def non_terminated_nodes(self):
            return {}

    a = Autoscaler(
        Provider(),
        {"slice": NodeTypeConfig(resources={"SLICE": 1.0}, max_workers=8)},
    )
    nodes = {
        "n0": {"labels": {"slice": "s0"}, "resources": {"SLICE": 1.0},
               "available": {"SLICE": 1.0}},
        "n1": {"labels": {"slice": "s0"}, "resources": {"SLICE": 1.0},
               "available": {"SLICE": 1.0}},
        "n2": {"labels": {}, "resources": {"SLICE": 1.0},
               "available": {"SLICE": 1.0}},
    }
    draining = {
        nid: {"reason": "preempt", "deadline_ts": time.time() + 60}
        for nid in nodes
    }
    counts: dict = {}
    a._handle_draining(draining, nodes, counts)
    # s0 (two hosts) → 1 launch; n2 (unlabeled) → 1 launch.
    assert created == ["slice", "slice"]
    # Idempotent across ticks while the same units are draining.
    a._handle_draining(draining, nodes, counts)
    assert len(created) == 2


def test_chronic_straggler_surfaces_to_autoscaler(cluster):
    """collective_straggler_total resolves rank→node on the head, and the
    autoscaler flags a node past the threshold (log + metric)."""
    from ray_tpu_torch.util import state

    rt = ray_tpu_torch.api._runtime
    nodes = state.list_nodes()
    nid, node_addr = nodes[0]["node_id"], nodes[0]["addr"]
    rt.run(
        rt.core.head.call(
            "collective_register",
            group="sg", rank=0, epoch=0, addr="fake",
            node_addr=node_addr, worker_id="w_straggle",
        )
    )
    snap = {
        "collective_straggler_total": {
            "kind": "counter",
            "description": "",
            "series": {'group="sg",rank="0"': 25.0},
            "boundaries": None,
        }
    }
    rt.run(
        rt.core.head.call(
            "report_metrics", worker="fake_hub", metrics=snap
        )
    )
    try:
        stats = rt.run(rt.core.head.call("collective_straggler_stats"))
        assert stats["nodes"].get(nid) == 25.0
        assert stats["groups"]["sg"]["0"] == 25.0

        from ray_tpu_torch.autoscaler.autoscaler import _CHRONIC_STRAGGLER

        asc = Autoscaler.__new__(Autoscaler)  # flagging logic only
        asc.straggler_threshold = 20
        asc._flagged_stragglers = set()
        chronic = asc._check_stragglers(asc._straggler_node_counts())
        assert chronic.get(nid) == 25.0
        assert nid in asc._flagged_stragglers
        assert _CHRONIC_STRAGGLER.value(tags={"node": nid}) == 25.0
    finally:
        rt.run(rt.core.head.call("collective_deregister", group="sg"))
