"""The port's GCE/GKE GPU node provider against recorded HTTP fixtures
(no test reaches Google), held to the JAX package's TPU provider.

- Every ``node_pool`` script of tests/test_gke_provider.py runs against
  both ``ray_tpu.autoscaler.gcp.GkeTpuNodeProvider`` and the port's
  ``GkeGpuNodeProvider``: each consumes the whole script (``assert_done``),
  makes the same calls and returns the same ids and errors. The pools
  here are node_pool only, so the TPU provider lists no queued resources
  and the two scripts are one.
- The four ``queued_resource`` cases become ``instance``-mode cases (a
  GCE instance per node): scale-up, terminate with 404 tolerance, a
  non-404 propagating, label-filtered membership; each asserts the
  request bodies.
- The autoscaler loop drives the GPU provider from an unschedulable GPU
  demand to a create and, idle, to a delete.
"""

import copy
import json

import pytest

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, NodeTypeConfig
from ray_tpu_torch.autoscaler.gcp import (
    GcpHttpError,
    GkeGpuNodeProvider,
    RecordedTransport,
)

GKE = "https://container.googleapis.com/v1"
ZONE = ("https://compute.googleapis.com/compute/v1/projects/proj/zones/"
        "us-central1-a")
POOL_URL = (f"{GKE}/projects/proj/locations/us-central1-a/clusters/"
            "mycluster/nodePools/h100-pool")
NODE_POOLS = {"gke-h100": {"mode": "node_pool", "pool": "h100-pool"}}
INSTANCE = {
    "mode": "instance",
    "machine_type": "a3-highgpu-8g",
    "image": "projects/proj/global/images/gpu-node",
}
IG = ("https://www.googleapis.com/compute/v1/projects/proj/zones/"
      "us-central1-a/instanceGroups/gke-mycluster-h100-pool-grp")
IGM = IG.replace("/instanceGroups/", "/instanceGroupManagers/")


def _mi(names):
    return {
        "managedInstances": [
            {"instance": f"{IGM.rsplit('/', 2)[0]}/instances/{n}"}
            for n in names
        ]
    }


def make_provider(script, pools=None, cls=GkeGpuNodeProvider, lookup=None):
    t = RecordedTransport(script)
    p = cls(
        "proj",
        "us-central1-a",
        "mycluster",
        pools or {"a3-8g": INSTANCE, **NODE_POOLS},
        transport=t,
        runtime_lookup=lookup or (lambda pid: None),
        operation_poll_s=0.0,
    )
    return p, t


def both(script, drive, pending_grow=None, tracked=()):
    """Run ``drive(provider)`` over a fresh copy of ``script`` for the JAX
    package's TPU provider and the port's GPU provider (both on
    node_pool-only pools). Each must consume the script to its end; the
    two must make the same calls and give the same result or error, and
    end with the same tracked ids. Returns (result or error, provider)."""
    from ray_tpu.autoscaler.gcp import GcpHttpError as RefHttpError
    from ray_tpu.autoscaler.gcp import GkeTpuNodeProvider
    from ray_tpu.autoscaler.gcp import RecordedTransport as RefTransport

    runs = []
    for cls, transport in ((GkeTpuNodeProvider, RefTransport),
                           (GkeGpuNodeProvider, RecordedTransport)):
        t = transport(copy.deepcopy(script))
        p = cls("proj", "us-central1-a", "mycluster", NODE_POOLS,
                transport=t, runtime_lookup=lambda pid: None,
                operation_poll_s=0.0)
        if pending_grow is not None:
            p._pending_grow["h100-pool"] = pending_grow
        for pid in tracked:
            p._nodes[pid] = "gke-h100"
        try:
            out = ("ok", drive(p))
        except (GcpHttpError, RefHttpError) as e:
            out = ("GcpHttpError", e.status, str(e))
        except RuntimeError as e:
            out = (type(e).__name__, str(e))
        t.assert_done()
        runs.append((out, t.calls, dict(p._nodes), dict(p._pending_grow),
                     p))
    (ref, ref_calls, ref_nodes, ref_grow, _), (got, calls, nodes, grow,
                                               gpu) = runs
    assert got == ref
    assert calls == ref_calls
    assert nodes == ref_nodes and grow == ref_grow
    return got, gpu


# ------------------------------------------------------- node_pool mode
def test_gke_node_pool_resize_up_down():
    script = [
        {"method": "GET", "url": POOL_URL,  # create's before-snapshot
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,  # _resize_pool's in-lock read
         "response": {"currentNodeCount": 2}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["3"],
         "response": {"name": "op-up", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,  # post-resize verification
         "response": {"currentNodeCount": 3}},
        {"method": "GET", "url": POOL_URL,  # membership listing
         "response": {"currentNodeCount": 3}},
        {"method": "GET", "url": POOL_URL,  # terminate's resolution read
         "response": {"currentNodeCount": 3}},
        {"method": "GET", "url": POOL_URL,  # _resize_pool's in-lock read
         "response": {"currentNodeCount": 3}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["2"],
         "response": {"name": "op-down", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,  # scale-down verification
         "response": {"currentNodeCount": 2}},
    ]

    def drive(p):
        pid = p.create_node("gke-h100", {"GPU": 8})
        members = p.non_terminated_nodes()
        p.terminate_node(pid)
        return pid, members, pid in p._nodes

    got, _ = both(script, drive)
    # Slot-indexed: reconstructable after a provider restart.
    assert got == ("ok", ("h100-pool#2", {"h100-pool#0": "gke-h100",
                                          "h100-pool#1": "gke-h100",
                                          "h100-pool#2": "gke-h100"},
                          False))


def test_pool_membership_survives_provider_restart():
    """A FRESH provider (no in-memory state) still sees pool VMs from the
    API and can terminate them — no leaked paid VMs after an autoscaler
    restart."""
    script = [
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,  # terminate's resolution read
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,  # _resize_pool's in-lock read
         "response": {"currentNodeCount": 2}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["1"],
         "response": {"name": "op", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,  # scale-down verification
         "response": {"currentNodeCount": 1}},
    ]

    def drive(p):
        members = p.non_terminated_nodes()
        p.terminate_node("h100-pool#1")  # never created by this provider
        return members

    got, _ = both(script, drive)
    assert got == ("ok", {"h100-pool#0": "gke-h100",
                          "h100-pool#1": "gke-h100"})


def test_gke_setsize_lost_update_retries_from_fresh_read():
    """A concurrent writer clobbers our setSize between write and verify:
    the re-read observes the stale count and the whole read-modify-write
    retries from a fresh read — the increment is NOT silently lost."""
    script = [
        {"method": "GET", "url": POOL_URL,  # create snapshot
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 2}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["3"],
         "response": {"name": "op1", "status": "DONE"}},
        # Verify observes 2: an operator's concurrent setSize(2)
        # overwrote ours. Retry re-reads and re-applies.
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["3"],
         "response": {"name": "op2", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 3}},
    ]
    got, _ = both(script, lambda p: p.create_node("gke-h100", {"GPU": 8}))
    assert got == ("ok", "h100-pool#2")


def test_gke_setsize_conflict_rereads_before_retry():
    """GKE's operation-in-flight conflict (409) triggers a re-read — the
    retry bases its target on the NEW current count."""
    script = [
        {"method": "GET", "url": POOL_URL,  # create snapshot
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 2}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["3"], "error_status": 409,
         "error_body": "cluster is running an operation"},
        # Fresh read sees the racing increment already applied.
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 3}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["4"],
         "response": {"name": "op", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 4}},
    ]
    got, _ = both(script, lambda p: p.create_node("gke-h100", {"GPU": 8}))
    assert got == ("ok", "h100-pool#3")


def test_gke_targeted_scale_down_deletes_the_named_instance():
    """When the pool exposes its instance groups, ids are instance names,
    and terminate deletes THAT instance via the MIG — GKE cannot pick a
    busy VM as the scale-down victim."""
    with_igs = {"instanceGroupUrls": [IG]}
    script = [
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 1, **with_igs}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa"])},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 1, **with_igs}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["2"],
         "response": {"name": "op-up", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, **with_igs}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa", "gke-node-bbb"])},
        # terminate(pool#gke-node-bbb): resolve → deleteInstances.
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, **with_igs}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa", "gke-node-bbb"])},
        {"method": "POST", "url": f"{IGM}/deleteInstances",
         "body_contains": ["gke-node-bbb"],
         "response": {"name": "op-del", "status": "DONE"}},
    ]

    def drive(p):
        pid = p.create_node("gke-h100", {"GPU": 8})
        p.terminate_node(pid)
        return pid, pid in p._nodes

    got, _ = both(script, drive)
    assert got == ("ok", ("h100-pool#gke-node-bbb", False))


def test_gke_clamped_noop_resize_skips_the_write():
    """Scale-down of an already-empty pool clamps target == current: no
    setSize is issued and no lost-update false positive burns retries."""
    script = [
        {"method": "GET", "url": POOL_URL,  # terminate's read
         "response": {"currentNodeCount": 0}},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 0}},
    ]
    got, _ = both(script, lambda p: p.terminate_node("h100-pool#0"))
    assert got == ("ok", None)


def test_gke_instance_listing_lag_retries_until_visible():
    """The MIG listing can lag the resize; create_node re-reads until the
    new instance shows instead of falling back to a slot id."""
    with_igs = {"instanceGroupUrls": [IG]}
    script = [
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 1, **with_igs}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa"])},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 1, **with_igs}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["2"],
         "response": {"name": "op-up", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, **with_igs}},
        # Lagging listing: still only the old instance.
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa"])},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, **with_igs}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa", "gke-node-new"])},
    ]
    got, _ = both(script, lambda p: p.create_node("gke-h100", {"GPU": 8}))
    assert got == ("ok", "h100-pool#gke-node-new")


def test_gke_membership_lists_instance_backed_ids():
    script = [
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, "instanceGroupUrls": [IG]}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa", "gke-node-bbb"])},
    ]
    got, _ = both(script, lambda p: p.non_terminated_nodes())
    assert got == ("ok", {"h100-pool#gke-node-aaa": "gke-h100",
                          "h100-pool#gke-node-bbb": "gke-h100"})


def test_gke_legacy_slot_id_maps_to_sorted_instance():
    """A slot id recorded before the pool exposed instance groups still
    terminates a specific instance: slot i = i-th instance in name
    order."""
    script = [
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, "instanceGroupUrls": [IG]}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-bbb", "gke-node-aaa"])},
        {"method": "POST", "url": f"{IGM}/deleteInstances",
         "body_contains": ["gke-node-bbb"],
         "response": {"name": "op-del", "status": "DONE"}},
    ]
    # sorted: [aaa, bbb] → slot 1 = bbb
    got, _ = both(script, lambda p: p.terminate_node("h100-pool#1"))
    assert got == ("ok", None)


def test_gke_terminate_missing_instance_is_noop():
    """A retried terminate whose instance is already gone must NOT fall
    back to an anonymous shrink — it treats the terminate as done."""
    script = [
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 1, "instanceGroupUrls": [IG]}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa"])},
        # no deleteInstances, no setSize: nothing else happens
    ]
    got, gpu = both(script,
                    lambda p: p.terminate_node("h100-pool#gke-node-gone"),
                    tracked=("h100-pool#gke-node-gone",))
    assert got == ("ok", None)
    assert "h100-pool#gke-node-gone" not in gpu._nodes


def test_plain_400_validation_error_is_not_retried():
    """A permanent 400 (not the operation-in-flight phrasing) surfaces at
    once, without burning the retry budget."""
    script = [
        {"method": "GET", "url": POOL_URL,  # create snapshot
         "response": {"currentNodeCount": 2}},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 2}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "error_status": 400, "error_body": "Invalid value for nodeCount"},
    ]
    got, _ = both(script, lambda p: p.create_node("gke-h100", {"GPU": 8}))
    assert got[:2] == ("GcpHttpError", 400)


def test_listing_lag_retry_claims_the_orphan_without_resizing():
    """When setSize(+1) succeeds but the managed-instance listing never
    shows the new instance, create_node neither shrinks nor lets the
    retry resize again: the failure records the grow and the retry claims
    the instance once the listing catches up, never a pre-existing
    member."""
    lagged = _mi(["gke-node-aaa"])
    grown = {"currentNodeCount": 2, "instanceGroupUrls": [IG]}
    script = [
        {"method": "GET", "url": POOL_URL,  # before-snapshot
         "response": {"currentNodeCount": 1, "instanceGroupUrls": [IG]}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": lagged},
        {"method": "GET", "url": POOL_URL,  # in-lock resize read
         "response": {"currentNodeCount": 1, "instanceGroupUrls": [IG]}},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["2"],
         "response": {"name": "op-up", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL, "response": grown},
        # attempt 0 reuses the verify body; attempts 1-4 re-read.
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": lagged},
        *[entry for _ in range(4) for entry in (
            {"method": "GET", "url": POOL_URL, "response": grown},
            {"method": "POST", "url": f"{IGM}/listManagedInstances",
             "response": lagged})],
        # retry: the listing has caught up; the orphan (outside the
        # pre-grow basis) is claimed with NO setSize.
        {"method": "GET", "url": POOL_URL, "response": grown},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa", "gke-node-bbb"])},
    ]

    def drive(p):
        with pytest.raises(RuntimeError, match="grow recorded"):
            p.create_node("gke-h100", {"GPU": 8})
        state = (dict(p._nodes), dict(p._pending_grow))
        return state, p.create_node("gke-h100", {"GPU": 8})

    got, gpu = both(script, drive)
    assert got == ("ok", (({}, {"h100-pool": frozenset({"gke-node-aaa"})}),
                          "h100-pool#gke-node-bbb"))
    assert "h100-pool" not in gpu._pending_grow


def test_externally_shrunk_pending_grow_unwedges_the_pool():
    """A pending grown instance removed externally before the retry can
    claim it: the claim clears the stale entry and falls through to a
    fresh resize instead of wedging the pool."""
    lagged = _mi(["gke-node-aaa"])
    back_to_one = {"currentNodeCount": 1, "instanceGroupUrls": [IG]}
    script = [
        *[entry for _ in range(5) for entry in (
            {"method": "GET", "url": POOL_URL, "response": back_to_one},
            {"method": "POST", "url": f"{IGM}/listManagedInstances",
             "response": lagged})],
        # fall-through: fresh resize, listing keeps up this time.
        {"method": "GET", "url": POOL_URL, "response": back_to_one},
        {"method": "POST", "url": f"{POOL_URL}:setSize",
         "body_contains": ["2"],
         "response": {"name": "op-up", "status": "DONE"}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 2, "instanceGroupUrls": [IG]}},
        {"method": "POST", "url": f"{IGM}/listManagedInstances",
         "response": _mi(["gke-node-aaa", "gke-node-ccc"])},
    ]
    got, gpu = both(script, lambda p: p.create_node("gke-h100", {"GPU": 8}),
                    pending_grow=frozenset({"gke-node-aaa"}))
    assert got == ("ok", "h100-pool#gke-node-ccc")
    assert "h100-pool" not in gpu._pending_grow


# -------------------------------------------------------- instance mode
def _body(t, i=0):
    return t.calls[i][2]


@pytest.mark.parametrize("variant", ["on_demand", "spot_n1", "reserved_any",
                                     "reserved_named"])
def test_instance_scale_up(variant):
    """One create is one compute instances insert: the node type's
    machine type and boot image, the cluster and node-type labels, the
    provider id in the instance's metadata under the key the node reads,
    and the zone's operation polled to DONE."""
    spec = dict(INSTANCE)
    if variant == "spot_n1":
        spec.update(machine_type="n1-standard-8", accelerator="nvidia-t4",
                    accelerator_count=2, spot=True)
    elif variant == "reserved_any":
        spec["reserved"] = True
    elif variant == "reserved_named":
        spec["reserved"] = "h100-reservation"
    p, t = make_provider(
        [
            {"method": "POST", "url": f"{ZONE}/instances",
             "body_contains": [spec["machine_type"], "ray-tpu-cluster",
                               "mycluster", "ray-tpu-node-type",
                               "ray-tpu-provider-id"],
             "response": {"name": "op1", "status": "RUNNING",
                          "selfLink": f"{ZONE}/operations/op1"}},
            {"method": "GET", "url": f"{ZONE}/operations/op1",
             "response": {"name": "op1", "status": "RUNNING"}},
            {"method": "GET", "url": f"{ZONE}/operations/op1",
             "response": {"name": "op1", "status": "DONE"}},
        ],
        pools={"gpu-node": spec},
    )
    pid = p.create_node("gpu-node", {"GPU": 8})
    t.assert_done()
    assert pid.startswith("ray-tpu-mycluster-")
    assert p._nodes == {pid: "gpu-node"}
    body = _body(t)
    assert body["name"] == pid
    assert body["machineType"] == (
        f"zones/us-central1-a/machineTypes/{spec['machine_type']}")
    assert body["labels"] == {"ray-tpu-cluster": "mycluster",
                              "ray-tpu-node-type": "gpu-node"}
    assert body["metadata"] == {
        "items": [{"key": "ray-tpu-provider-id", "value": pid}]}
    assert body["disks"][0]["boot"] is True
    assert body["disks"][0]["initializeParams"] == {
        "sourceImage": spec["image"]}
    assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
    if variant == "spot_n1":
        assert body["guestAccelerators"] == [{
            "acceleratorType":
                "zones/us-central1-a/acceleratorTypes/nvidia-t4",
            "acceleratorCount": 2}]
        assert body["scheduling"]["provisioningModel"] == "SPOT"
        assert body["scheduling"]["automaticRestart"] is False
    else:
        assert "guestAccelerators" not in body
        assert "provisioningModel" not in body["scheduling"]
    if variant == "reserved_any":
        assert body["reservationAffinity"] == {
            "consumeReservationType": "ANY_RESERVATION"}
    elif variant == "reserved_named":
        assert body["reservationAffinity"] == {
            "consumeReservationType": "SPECIFIC_RESERVATION",
            "key": "compute.googleapis.com/reservation-name",
            "values": ["h100-reservation"]}
    else:
        assert "reservationAffinity" not in body


def test_instance_operation_error_raises():
    """An insert whose operation ends with an ``error`` raises, and the
    node is not tracked."""
    p, t = make_provider([
        {"method": "POST", "url": f"{ZONE}/instances",
         "response": {"name": "op9", "status": "PENDING"}},
        {"method": "GET", "url": f"{ZONE}/operations/op9",
         "response": {"name": "op9", "status": "DONE", "error": {
             "errors": [{"code": "ZONE_RESOURCE_POOL_EXHAUSTED"}]}}},
    ])
    with pytest.raises(RuntimeError, match="ZONE_RESOURCE_POOL_EXHAUSTED"):
        p.create_node("a3-8g", {"GPU": 8})
    assert p._nodes == {}
    t.assert_done()


def test_instance_terminate_and_404_tolerance():
    p, t = make_provider([
        {"method": "DELETE", "url": f"{ZONE}/instances/ray-tpu-c-1",
         "response": {"name": "del1", "status": "RUNNING"}},
        {"method": "GET", "url": f"{ZONE}/operations/del1",
         "response": {"name": "del1", "status": "DONE"}},
        {"method": "DELETE", "url": f"{ZONE}/instances/ray-tpu-c-2",
         "error_status": 404},
    ])
    p._nodes["ray-tpu-c-1"] = "a3-8g"
    p._nodes["ray-tpu-c-2"] = "a3-8g"
    p.terminate_node("ray-tpu-c-1")
    p.terminate_node("ray-tpu-c-2")  # already gone: not an error
    assert not p._nodes
    t.assert_done()
    assert [c[2] for c in t.calls] == [None, None, None]


def test_instance_terminate_propagates_non_404():
    p, t = make_provider([
        {"method": "DELETE", "url": f"{ZONE}/instances/ray-tpu-c-3",
         "error_status": 403, "error_body": "permission denied"},
    ])
    p._nodes["ray-tpu-c-3"] = "a3-8g"
    with pytest.raises(GcpHttpError) as ei:
        p.terminate_node("ray-tpu-c-3")
    assert ei.value.status == 403
    assert "ray-tpu-c-3" in p._nodes
    t.assert_done()


def test_instance_membership_is_label_filtered():
    """Membership is the zone's instances under the cluster-label filter,
    page by page; another cluster's instance and instances in a terminal
    state are left out; node_pool members follow."""
    def inst(name, status, cluster="mycluster", node_type="a3-8g"):
        return {"name": name, "status": status,
                "labels": {"ray-tpu-cluster": cluster,
                           "ray-tpu-node-type": node_type}}

    listing = f"{ZONE}/instances?filter=labels.ray-tpu-cluster%3Dmycluster"
    p, t = make_provider([
        {"method": "GET", "url": listing, "response": {
            "items": [inst("ray-tpu-mycluster-a", "RUNNING"),
                      inst("ray-tpu-mycluster-b", "PROVISIONING"),
                      inst("ray-tpu-them-c", "RUNNING", cluster="them"),
                      inst("ray-tpu-mycluster-d", "TERMINATED"),
                      inst("ray-tpu-mycluster-e", "STOPPED")],
            "nextPageToken": "p2"}},
        {"method": "GET", "url": f"{listing}&pageToken=p2", "response": {
            "items": [inst("ray-tpu-mycluster-f", "STAGING")]}},
        {"method": "GET", "url": POOL_URL,
         "response": {"currentNodeCount": 1}},
    ])
    assert p.non_terminated_nodes() == {
        "ray-tpu-mycluster-a": "a3-8g",
        "ray-tpu-mycluster-b": "a3-8g",
        "ray-tpu-mycluster-f": "a3-8g",
        "h100-pool#0": "gke-h100",
    }
    t.assert_done()


# ------------------------------------------------------------- the loop
def test_autoscaler_drives_gke_provider(monkeypatch):
    """A GPU demand spike produces the instance insert through
    bin-packing, and idle produces the delete — the full loop with no
    cluster (head status is stubbed)."""
    script = [
        {"method": "POST", "url": f"{ZONE}/instances",
         "body_contains": ["a3-highgpu-8g"],
         "response": {"name": "op-as", "status": "DONE"}},
        {"method": "DELETE", "url": None,
         "response": {"name": "del-as", "status": "DONE"}},
    ]
    t = RecordedTransport(script)
    real_request = t.request

    def patched(method, url, body=None):
        if method == "POST":
            t.script[1]["url"] = f"{ZONE}/instances/{body['name']}"
        return real_request(method, url, body)

    t.request = patched
    registered = {}  # pid → runtime node id
    provider = GkeGpuNodeProvider(
        "proj", "us-central1-a", "mycluster", {"a3-8g": INSTANCE},
        transport=t, runtime_lookup=lambda pid: registered.get(pid),
        operation_poll_s=0.0,
    )
    scaler = Autoscaler(
        provider,
        {"a3-8g": NodeTypeConfig(resources={"GPU": 8.0, "CPU": 8.0})},
        idle_timeout_s=0.0,
        boot_grace_s=600.0,
    )

    # Tick 1: one unschedulable 8-GPU demand → exactly one VM.
    status = {"unschedulable": [{"GPU": 8.0}], "nodes": {}}
    monkeypatch.setattr(scaler, "_cluster_status", lambda: status)
    scaler.update()
    assert len(provider._nodes) == 1
    pid = next(iter(provider._nodes))

    # Tick 2: the VM registered and sits idle → scale-down.
    registered[pid] = "node-abc"
    status = {
        "unschedulable": [],
        "nodes": {
            "node-abc": {
                "addr": "10.0.0.9:1",
                "resources": {"GPU": 8.0, "CPU": 8.0},
                "available": {"GPU": 8.0, "CPU": 8.0},
                "pending": [],
            }
        },
    }
    scaler.update()
    scaler.update()  # idle_since set on first tick, reaped on second
    assert not provider._nodes
    t.assert_done()
    assert json.dumps(t.calls[0][2]).count(pid) == 2  # name and metadata


def test_transport_token_expiry_and_401_refresh(monkeypatch):
    """The bearer cache honors the provider's expires_in (minus margin)
    and a 401 invalidates the cached token before one retry."""
    import time as _time
    import urllib.error
    import urllib.request as _ur

    from ray_tpu_torch.autoscaler.gcp import GcpTransport

    tokens = iter([("tok-1", 120.0), ("tok-2", 3600.0), ("tok-3", 3600.0)])
    fetched = []

    def provider():
        tok = next(tokens)
        fetched.append(tok[0])
        return tok

    tr = GcpTransport(token_provider=provider)
    assert tr._bearer() == "tok-1"
    assert tr._bearer() == "tok-1"  # cached
    # 120s lifetime - 60s margin: expired after 61s.
    real_now = _time.time()
    monkeypatch.setattr(_time, "time", lambda: real_now + 100)
    assert tr._bearer() == "tok-2"
    assert fetched == ["tok-1", "tok-2"]

    # A 401 response invalidates the cache and retries once fresh.
    calls = []

    def fake_urlopen(req, timeout=0):
        calls.append(req.headers["Authorization"])
        if len(calls) == 1:
            raise urllib.error.HTTPError(
                req.full_url, 401, "unauthorized", {}, None
            )

        class R:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def read(self):
                return b'{"ok": true}'

        return R()

    monkeypatch.setattr(_ur, "urlopen", fake_urlopen)
    out = tr.request("GET", "https://example.invalid/x")
    assert out == {"ok": True}
    assert calls == ["Bearer tok-2", "Bearer tok-3"]
