"""GCE/GKE GPU node provider: real REST calls behind a transport seam.

Reference shape: python/ray/autoscaler/_private/gcp/node_provider.py +
node.py — a GCPResource per API (compute/container) doing REST calls
through an authorized http object, with operation polling and
label-based cluster membership. The scaling unit is a GPU VM (all the
GPUs of its machine type); a unit of several VMs is whatever shares a
``slice`` node label, as in the head. Two provisioning paths:

- ``instance`` (Compute Engine ``instances.insert``): one VM per create,
  its machine type (``a3-highgpu-8g`` carries eight H100s; types such as
  N1 take ``guestAccelerators``) and boot image from the node type's
  spec, spot as ``provisioningModel: SPOT``, reserved capacity as a
  reservation affinity. Every instance is labeled with the cluster name
  and node type, so membership listing is a label filter, and the
  provider id is stamped into instance metadata — the node daemon's
  detect_labels probes GCE metadata (node.py _gce_metadata_labels) and
  registers it as a node label, which runtime_node_id matches against
  the head's node table.
- ``node_pool`` (GKE ``nodePools:setSize``) — a GKE GPU node pool, one
  size increment = one VM. setSize is anonymous, so it cannot stamp
  per-increment metadata; instead the daemon registers its GCE instance
  name (``ray-tpu-gce-instance`` label) and the provider ids carry the
  instance name when the pool exposes its instance groups, so
  scale-down can target the exact idle instance.

``instance`` is the RECOMMENDED mode: creation is atomic (one insert
per create) and deletion names the VM. ``node_pool`` rides GKE's
setSize, whose read-modify-write is guarded here by a per-pool lock,
conflict retry, and a post-resize verification re-read; when the pool
response carries ``instanceGroupUrls``, scale-down uses the
managed-instance-group ``deleteInstances`` call on the specific victim
instead of an anonymous shrink.

The GCE notice source (``GceMaintenanceEventSource``) is what the node
daemon polls on a Google VM for a preemption or maintenance notice.

Auth rides a bearer token: ``GOOGLE_OAUTH_ACCESS_TOKEN`` env when set
(CI/dev), else the GCE metadata server (in-cluster). CI never talks to
Google: tests drive the provider through RecordedTransport fixtures.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
import urllib.request
import uuid
from typing import Any, Callable

from ray_tpu_torch.autoscaler.providers import NodeProvider

logger = logging.getLogger("ray_tpu_torch.autoscaler")

_COMPUTE_API = "https://compute.googleapis.com/compute/v1"
_GKE_API = "https://container.googleapis.com/v1"
_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/service-accounts/default/token"
)


_MAINTENANCE_EVENT_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/maintenance-event"
)
_PREEMPTED_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/preempted"
)


class GceMaintenanceEventSource:
    """Preemption-notice source for the node daemon's drain watcher
    (runtime/node.py): polls the GCE metadata server's maintenance-event
    and preempted endpoints. A value other than NONE/FALSE means this VM
    is about to be migrated or preempted — the node self-reports DRAIN
    with the standard notice window so the trainer's emergency
    checkpoint and the autoscaler's replacement both start inside it.

    Only constructed on GCE hosts (the DMI product-name gate in
    NodeManager._preemption_source keeps other machines off the
    metadata endpoint). ``fetch`` is a seam for tests."""

    interval_s = 5.0

    def __init__(self, fetch: Callable[[str], str] | None = None):
        self._fetch = fetch or self._metadata_get

    @staticmethod
    def _metadata_get(url: str) -> str:
        req = urllib.request.Request(
            url, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=2) as resp:
            return resp.read().decode().strip()

    def poll(self, node) -> "tuple[str, float] | None":
        del node
        from ray_tpu_torch._private import config

        try:
            if self._fetch(_PREEMPTED_URL).upper() == "TRUE":
                return ("gce-preempted", config.get("DRAIN_DEADLINE_S"))
        except OSError:
            pass
        try:
            event = self._fetch(_MAINTENANCE_EVENT_URL)
        except OSError:
            return None
        if event and event.upper() != "NONE":
            return (
                f"gce-maintenance:{event}",
                config.get("DRAIN_DEADLINE_S"),
            )
        return None


class GcpHttpError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body[:500]}")
        self.status = status
        self.body = body

    def is_conflict(self) -> bool:
        """GKE rejects a mutation while another cluster operation is in
        flight (409/412, or 400 FAILED_PRECONDITION whose message names
        the running operation). These are safe to retry after a
        re-read. Plain 400 validation errors are NOT retryable — only
        the operation-in-flight phrasing qualifies."""
        if self.status in (409, 412, 429):
            return True
        if self.status != 400:
            return False
        # Only the operation-in-flight phrasing qualifies; a permanent
        # FAILED_PRECONDITION (pool managed by cluster autoscaling,
        # pool being deleted, ...) must surface immediately.
        body = self.body.lower()
        return "operation" in body and (
            "in progress" in body or "running" in body or "wait" in body
        )


class GcpTransport:
    """Minimal authorized REST transport (the AuthorizedHttp analogue,
    reference node.py:240)."""

    def __init__(
        self,
        token_provider: Callable[[], "str | tuple[str, float]"] | None = None,
    ):
        self._token_provider = token_provider or self._default_token
        self._token: str | None = None
        self._token_expiry = 0.0

    @staticmethod
    def _default_token() -> tuple[str, float]:
        import os

        env = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if env:
            return env, 600.0
        req = urllib.request.Request(
            _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = json.loads(resp.read())
        return payload["access_token"], float(payload.get("expires_in", 600))

    def _bearer(self) -> str:
        if self._token is None or time.time() > self._token_expiry:
            got = self._token_provider()
            # Providers may return a bare token or (token, expires_in).
            token, expires_in = got if isinstance(got, tuple) else (got, 600.0)
            self._token = token
            # Honor the server's actual lifetime, minus a safety margin so
            # a token fetched near expiry isn't cached past its death.
            self._token_expiry = time.time() + max(expires_in - 60.0, 10.0)
        return self._token

    def _invalidate_token(self) -> None:
        self._token = None
        self._token_expiry = 0.0

    def request(
        self, method: str, url: str, body: dict | None = None
    ) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        for attempt in (0, 1):
            req = urllib.request.Request(
                url,
                data=data,
                method=method,
                headers={
                    "Authorization": f"Bearer {self._bearer()}",
                    "Content-Type": "application/json",
                },
            )
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    payload = resp.read()
                break
            except urllib.error.HTTPError as e:
                if e.code == 401 and attempt == 0:
                    # Stale cached token: drop it and retry once fresh.
                    self._invalidate_token()
                    continue
                raise GcpHttpError(e.code, e.read().decode("utf-8", "replace"))
        return json.loads(payload) if payload else {}


class RecordedTransport:
    """Replays a recorded call script (CI has zero egress). Each entry:
    {"method", "url", "response", optional "body_contains"}. Calls must
    arrive in order; mismatches raise with the diff."""

    def __init__(self, script: list[dict]):
        self.script = list(script)
        self.calls: list[tuple] = []
        self._i = 0

    def request(
        self, method: str, url: str, body: dict | None = None
    ) -> dict:
        self.calls.append((method, url, body))
        if self._i >= len(self.script):
            raise AssertionError(
                f"unexpected extra call #{self._i}: {method} {url}"
            )
        expect = self.script[self._i]
        self._i += 1
        if expect["method"] != method or expect["url"] != url:
            raise AssertionError(
                f"call #{self._i - 1}: got {method} {url}, expected "
                f"{expect['method']} {expect['url']}"
            )
        for fragment in expect.get("body_contains", ()):
            if fragment not in json.dumps(body or {}):
                raise AssertionError(
                    f"call #{self._i - 1}: body missing {fragment!r}: "
                    f"{body}"
                )
        if "error_status" in expect:
            raise GcpHttpError(expect["error_status"], expect.get(
                "error_body", ""
            ))
        return expect["response"]

    def assert_done(self):
        if self._i != len(self.script):
            raise AssertionError(
                f"{len(self.script) - self._i} scripted calls never "
                f"made: {self.script[self._i:]}"
            )


# Instance states from which a VM does not come back by itself: it holds
# no GPU and is left out of the cluster's membership.
_TERMINAL_STATES = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED",
                    "TERMINATED")


class GkeGpuNodeProvider(NodeProvider):
    """GPU-VM provider over the Compute Engine / GKE REST surface.

    ``node_pools`` maps node_type → pool spec:

        {"mode": "instance", "machine_type": "a3-highgpu-8g",
         "image": "projects/<p>/global/images/<image>", "spot": False}
      (optional: "accelerator" and "accelerator_count" for machine types
      that take guestAccelerators, "reserved": True for any matching
      reservation or a reservation's name, "network")
      or
        {"mode": "node_pool", "pool": "gpu-h100-pool"}

    One create_node == one VM; terminate reaps it. A unit of several
    VMs (one ``slice`` label) reaps through terminate_nodes.
    """

    def __init__(
        self,
        project: str,
        location: str,
        cluster: str,
        node_pools: dict[str, dict],
        transport=None,
        runtime_lookup: Callable[[str], str | None] | None = None,
        operation_poll_s: float = 2.0,
        node_table_cache_s: float = 2.0,
    ):
        self.project = project
        self.location = location
        self.cluster = cluster
        self.node_pools = node_pools
        self.http = transport or GcpTransport()
        self._runtime_lookup = runtime_lookup
        self._poll_s = operation_poll_s
        # One reconcile tick calls runtime_node_id once per tracked
        # VM; fetching + scanning the whole node table each time is
        # O(tracked x nodes) head RPCs. Cache a label index briefly.
        self._node_cache_s = node_table_cache_s
        self._label_index: dict[str, str] = {}
        self._label_index_expiry = 0.0
        # setSize is an absolute write: serialize our own resizes per
        # pool so two concurrent reconciles cannot interleave their
        # read-modify-write windows inside this process.
        self._pool_locks: dict[str, threading.RLock] = {}
        self._pool_locks_guard = threading.Lock()
        # provider_node_id → node_type cache of our own creations; the
        # authoritative list always comes from the API
        # (non_terminated_nodes), so a restarted provider process
        # re-discovers existing VMs instead of leaking them.
        self._nodes: dict[str, str] = {}
        # pool name → pre-grow membership snapshot, recorded when a
        # successful setSize(+1)'s new instance never surfaced in the
        # lagging MIG listing. The next create_node claims an instance
        # outside this basis (and untracked) instead of resizing again
        # — the basis is what distinguishes OUR lagged instance from
        # pre-existing members this provider never created. In-memory
        # only: after a restart the orphan is simply a normal pool
        # member visible through non_terminated_nodes.
        self._pending_grow: dict[str, frozenset] = {}
        # pool name → node_type reverse map for node_pool-mode ids
        # ("<pool>#<i>"), stable across provider restarts.
        self._pool_types = {
            spec["pool"]: nt
            for nt, spec in node_pools.items()
            if spec.get("mode") == "node_pool"
        }

    # ------------------------------------------------------------ paths
    @property
    def _zone_base(self) -> str:
        return (
            f"{_COMPUTE_API}/projects/{self.project}/zones/{self.location}"
        )

    def _gke_pool(self, pool: str) -> str:
        return (
            f"{_GKE_API}/projects/{self.project}/locations/"
            f"{self.location}/clusters/{self.cluster}/nodePools/{pool}"
        )

    def _wait_operation(self, op: dict, api: str, timeout: float = 300.0):
        """Poll a long-running operation to completion (reference:
        wait_for_operation, node.py:342). Zonal compute ops of this
        provider's own inserts and deletes are polled by name on the
        zone's operations; MIG ops (deleteInstances) carry a selfLink;
        GKE ops are project-relative."""
        def _check(done_op: dict) -> dict:
            if done_op.get("error"):
                raise RuntimeError(
                    f"operation {done_op.get('name')} failed: "
                    f"{done_op['error']}"
                )
            return done_op

        name = op.get("name", "")
        if op.get("done") or op.get("status") == "DONE" or not name:
            return _check(op)
        if api == "zone":
            url = f"{self._zone_base}/operations/{name.rsplit('/', 1)[-1]}"
        elif api == "compute":
            # Compute zonal ops (deleteInstances) carry a selfLink.
            url = op.get("selfLink") or name
            if not url.startswith("http"):
                return _check(op)
        else:
            url = (
                f"{_GKE_API}/projects/{self.project}/locations/"
                f"{self.location}/operations/{name.rsplit('/', 1)[-1]}"
            )
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = self.http.request("GET", url)
            if got.get("done") or got.get("status") == "DONE":
                return _check(got)
            time.sleep(self._poll_s)
        raise TimeoutError(f"operation {name} not done in {timeout}s")

    # ----------------------------------------------------- pool helpers
    def _pool_lock(self, name: str) -> threading.RLock:
        # Reentrant: create_node holds it across its read-diff-resize
        # sequence while _resize_pool re-acquires inside.
        with self._pool_locks_guard:
            return self._pool_locks.setdefault(name, threading.RLock())

    @staticmethod
    def _pool_count(got: dict) -> int:
        return int(
            got.get("currentNodeCount", got.get("initialNodeCount", 0))
        )

    def _list_pool_instances(
        self, pool_resp: dict
    ) -> "dict[str, tuple[str, str]] | None":
        """instance name → (instance_url, igm_url) for every managed
        instance backing the pool, or None when the pool response does
        not expose instance groups (then ids stay slot-indexed and
        scale-down falls back to an anonymous shrink)."""
        igs = pool_resp.get("instanceGroupUrls")
        if not igs:
            return None
        out: dict[str, tuple[str, str]] = {}
        for ig in igs:
            igm = ig.replace("/instanceGroups/", "/instanceGroupManagers/")
            got = self.http.request("POST", f"{igm}/listManagedInstances")
            for mi in got.get("managedInstances", []):
                inst_url = mi.get("instance", "")
                if inst_url:
                    out[inst_url.rsplit("/", 1)[-1]] = (inst_url, igm)
        return out

    def _resize_pool(self, name: str, delta: int) -> "tuple[int, dict]":
        """Conflict-safe GET → setSize(current+delta) → verify re-read.

        setSize is an absolute write, so the GET/POST window can lose a
        concurrent increment (another reconcile, an operator's kubectl).
        Three guards: a per-pool lock (in-process interleavings), retry
        on GKE's operation-in-flight conflicts, and a post-resize
        re-read — if the observed count moved the wrong way, the write
        was clobbered and the whole read-modify-write retries from a
        fresh read. The GET always happens INSIDE the lock: a count
        fetched before acquisition could be stale by the time the write
        goes out, which is the exact lost-update this guards against.
        Returns (size_before_our_write, verify_response).
        """
        with self._pool_lock(name):
            last_exc: Exception | None = None
            for attempt in range(4):
                # tpulint: allow(blocking-under-lock reason=the pool lock exists to hold the remote GET-setSize-verify window closed; releasing it around the REST calls reintroduces the lost-update race it prevents)
                got = self.http.request("GET", self._gke_pool(name))
                current = self._pool_count(got)
                target = max(0, current + delta)
                if target == current:
                    # Clamped no-op (scale-down of an already-empty
                    # pool): nothing to write, and the verify heuristic
                    # below would misread observed==current as a lost
                    # update.
                    return current, got
                try:
                    # tpulint: allow(blocking-under-lock reason=the setSize write IS the critical section the pool lock serializes)
                    op = self.http.request(
                        "POST",
                        f"{self._gke_pool(name)}:setSize",
                        {"nodeCount": target},
                    )
                except GcpHttpError as e:
                    if e.is_conflict():
                        last_exc = e
                        # tpulint: allow(blocking-under-lock reason=conflict backoff must keep the lock - another thread resizing during it would interleave its read into our retry window)
                        time.sleep(self._poll_s * (attempt + 1))
                        continue
                    raise
                self._wait_operation(op, "gke")
                # tpulint: allow(blocking-under-lock reason=the verify re-read belongs to the same locked read-modify-write window as the setSize above)
                verify = self.http.request("GET", self._gke_pool(name))
                observed = self._pool_count(verify)
                # observed == current (our write apparently never
                # happened) is the one unambiguous lost-update
                # signature — retry from a fresh read. Any OTHER
                # mismatch means a racing writer moved the count after
                # our write landed; re-applying the delta would
                # double-resize (e.g. delete a second node for one
                # terminate), so accept the observed state and let the
                # autoscaler's next reconcile tick correct any residual
                # drift through non_terminated_nodes.
                if observed != current or delta == 0:
                    return current, verify
                last_exc = RuntimeError(
                    f"pool {name} resize lost: wrote {target}, "
                    f"observed {observed}"
                )
                # tpulint: allow(blocking-under-lock reason=lost-update backoff keeps the lock so the fresh re-read stays serialized with other local resizes)
                time.sleep(self._poll_s * (attempt + 1))
            raise RuntimeError(
                f"pool {name} resize failed after 4 attempts"
            ) from last_exc

    # -------------------------------------------------------- provider
    def create_node(self, node_type: str, resources: dict) -> str:
        pool = self.node_pools[node_type]
        mode = pool.get("mode", "instance")
        if mode == "instance":
            inst = f"ray-tpu-{self.cluster}-{uuid.uuid4().hex[:8]}"
            zone = f"zones/{self.location}"
            # A GPU VM cannot live-migrate: host maintenance stops it.
            scheduling: dict[str, Any] = {
                "onHostMaintenance": "TERMINATE",
                "automaticRestart": not pool.get("spot"),
            }
            body: dict[str, Any] = {
                "name": inst,
                "machineType": f"{zone}/machineTypes/{pool['machine_type']}",
                "labels": {
                    "ray-tpu-cluster": self.cluster,
                    "ray-tpu-node-type": node_type,
                },
                "metadata": {
                    "items": [{"key": "ray-tpu-provider-id", "value": inst}],
                },
                "disks": [
                    {
                        "boot": True,
                        "autoDelete": True,
                        "initializeParams": {"sourceImage": pool["image"]},
                    }
                ],
                "networkInterfaces": [
                    {"network": pool.get("network", "global/networks/default")}
                ],
                "scheduling": scheduling,
            }
            if pool.get("accelerator"):
                body["guestAccelerators"] = [
                    {
                        "acceleratorType": (
                            f"{zone}/acceleratorTypes/{pool['accelerator']}"
                        ),
                        "acceleratorCount": int(
                            pool.get("accelerator_count", 1)
                        ),
                    }
                ]
            if pool.get("spot"):
                scheduling["provisioningModel"] = "SPOT"
                scheduling["instanceTerminationAction"] = "DELETE"
            reserved = pool.get("reserved")
            if isinstance(reserved, str):
                body["reservationAffinity"] = {
                    "consumeReservationType": "SPECIFIC_RESERVATION",
                    "key": "compute.googleapis.com/reservation-name",
                    "values": [reserved],
                }
            elif reserved:
                body["reservationAffinity"] = {
                    "consumeReservationType": "ANY_RESERVATION"
                }
            op = self.http.request("POST", f"{self._zone_base}/instances", body)
            # The insert's operation ends once the VM exists; its boot and
            # the node daemon's registration are NOT awaited — the
            # autoscaler's boot grace covers them (update() credits
            # unregistered capacity).
            self._wait_operation(op, "zone")
            self._nodes[inst] = node_type
            return inst
        if mode == "node_pool":
            name = pool["pool"]
            # The before-snapshot, resize, and after-diff must be one
            # critical section: with the lock taken only inside
            # _resize_pool, two concurrent creates could share a
            # before-set and pick the SAME new instance as their id.
            with self._pool_lock(name):
                # tpulint: allow(blocking-under-lock reason=the before-snapshot must be read inside the lock or two creates could share it and claim the same new instance)
                got = self.http.request("GET", self._gke_pool(name))
                before = self._list_pool_instances(got)
                if before is not None and name in self._pending_grow:
                    # A previous create grew the pool but the MIG
                    # listing never surfaced the instance. Claim an
                    # orphan (listed, outside the pre-grow basis, and
                    # untracked) instead of resizing again — the second
                    # setSize is how capacity leaks.
                    basis = self._pending_grow[name]
                    for attempt in range(5):
                        if attempt:
                            # tpulint: allow(blocking-under-lock reason=orphan-claim re-reads poll a lagging MIG listing; the lock must stay held so a concurrent create cannot claim the same orphan)
                            time.sleep(self._poll_s)
                            # tpulint: allow(blocking-under-lock reason=same locked orphan-claim window as the sleep above)
                            got = self.http.request(
                                "GET", self._gke_pool(name)
                            )
                            before = (
                                self._list_pool_instances(got) or {}
                            )
                        orphans = sorted(
                            inst for inst in set(before) - basis
                            if f"{name}#{inst}" not in self._nodes
                        )
                        if orphans:
                            del self._pending_grow[name]
                            pid = f"{name}#{orphans[0]}"
                            self._nodes[pid] = node_type
                            return pid
                    if self._pool_count(got) <= len(basis):
                        # The pool no longer holds the extra capacity
                        # (operator resize-down, quota rollback, MIG
                        # repair): the pending grow is gone for good.
                        # Clear it and fall through to a fresh resize —
                        # without this the pool is wedged until the
                        # provider restarts. (If the count is still
                        # above the basis, the capacity exists and only
                        # the listing lags: resizing now WOULD leak, so
                        # keep waiting across retries instead.)
                        del self._pending_grow[name]
                    else:
                        raise RuntimeError(
                            f"pool {name} has a pending grown instance"
                            " the managed-instance listing still does"
                            " not show"
                        )
                current, verify = self._resize_pool(name, +1)
                if before is not None:
                    # Instance-backed id: the instance the resize added,
                    # picked deterministically so the id stays
                    # consistent with instance-named membership listing.
                    # MIG listings can lag the resize, so re-read a few
                    # times; a slot-id fallback here would never match
                    # non_terminated_nodes and the autoscaler would
                    # treat the node as failed, so raise instead and
                    # let the reconcile retry cleanly.
                    for attempt in range(5):
                        if attempt:
                            # tpulint: allow(blocking-under-lock reason=naming the just-added instance re-reads a lagging MIG listing; dropping the lock would let a racing create adopt it)
                            time.sleep(self._poll_s)
                            # tpulint: allow(blocking-under-lock reason=same locked post-resize naming window as the sleep above)
                            verify = self.http.request(
                                "GET", self._gke_pool(name)
                            )
                        after = self._list_pool_instances(verify) or {}
                        new = sorted(set(after) - set(before))
                        if new:
                            pid = f"{name}#{new[0]}"
                            self._nodes[pid] = node_type
                            return pid
                    # The resize succeeded but we cannot name the new
                    # instance. Do NOT shrink: an anonymous setSize(-1)
                    # lets GKE pick the scale-in victim, which can kill
                    # a tracked busy VM while the new instance
                    # survives (the same hazard targeted scale-down
                    # exists to prevent). Record the grow instead so
                    # the reconcile retry CLAIMS the orphan rather than
                    # resizing +1 again — no compounding leak, and the
                    # instance surfaces in non_terminated_nodes once
                    # the listing catches up.
                    self._pending_grow[name] = frozenset(before)
                    raise RuntimeError(
                        f"pool {name} grew to {self._pool_count(verify)}"
                        " but the managed-instance listing never showed"
                        " the new instance (grow recorded; the retry"
                        " will claim it instead of resizing again)"
                    )
                # No instance groups exposed: slot-indexed ids,
                # derivable from the pool size, stable across provider
                # restarts.
                pid = f"{name}#{current}"
                self._nodes[pid] = node_type
                return pid
        raise ValueError(f"unknown provider mode {mode!r}")

    def terminate_node(self, provider_node_id: str) -> None:
        # The id SHAPE routes the call (not the in-memory cache, which
        # a restarted provider no longer has): "<pool>#<i>" is a GKE
        # pool slot, anything else is an instance.
        if "#" in provider_node_id:
            name, token = provider_node_id.split("#", 1)
            if name not in self._pool_types:
                raise ValueError(
                    f"unknown node pool in id {provider_node_id!r}"
                )
            got = self.http.request("GET", self._gke_pool(name))
            instances = self._list_pool_instances(got)
            if instances is not None:
                entry = instances.get(token)
                if entry is None and token.isdigit():
                    # Legacy slot id: map slot i to the i-th instance in
                    # name order (the same order membership listing
                    # would have assigned slots).
                    names = sorted(instances)
                    if int(token) < len(names):
                        entry = instances[names[int(token)]]
                if entry is not None:
                    inst_url, igm = entry
                    # Targeted removal: the MIG deletes THIS instance
                    # and decrements the target size — GKE cannot pick
                    # a busy VM as the victim.
                    with self._pool_lock(name):
                        # tpulint: allow(blocking-under-lock reason=targeted deleteInstances must not interleave with a concurrent resize of the same pool - the lock scope is the API call by design)
                        op = self.http.request(
                            "POST",
                            f"{igm}/deleteInstances",
                            {
                                "instances": [inst_url],
                                "skipInstancesOnValidationError": True,
                            },
                        )
                        self._wait_operation(op, "compute")
                else:
                    # The named instance no longer exists: the terminate
                    # already happened (retried call, provider restart).
                    # An anonymous shrink here would delete an ARBITRARY
                    # live instance — exactly what targeted scale-down
                    # exists to prevent. Treat as done.
                    pass
                self._nodes.pop(provider_node_id, None)
                return
            # No instance groups exposed: anonymous conflict-safe shrink
            # is the best the API offers.
            self._resize_pool(name, -1)
            self._nodes.pop(provider_node_id, None)
            return
        try:
            op = self.http.request(
                "DELETE", f"{self._zone_base}/instances/{provider_node_id}"
            )
            self._wait_operation(op, "zone")
        except GcpHttpError as e:
            if e.status != 404:  # already gone is success
                raise
        self._nodes.pop(provider_node_id, None)

    def terminate_nodes(self, provider_node_ids: "list[str]") -> None:
        """Batch termination for a fully-drained unit: every
        "<pool>#<instance>" id of the same pool collapses into ONE
        targeted deleteInstances call per managed instance group (the
        API takes a list) — a drained unit of 32 pool VMs costs one API
        round-trip, not 32. Instance ids are ALREADY whole
        VMs (one DELETE each is the unit call); ids whose instance
        cannot be batch-resolved (legacy slot ids past the listing,
        pools without instance groups) fall back to the single-node
        path, which never anonymously shrinks."""
        by_pool: dict[str, list[str]] = {}
        rest: list[str] = []
        for pid in provider_node_ids:
            if "#" in pid and pid.split("#", 1)[0] in self._pool_types:
                by_pool.setdefault(pid.split("#", 1)[0], []).append(pid)
            else:
                rest.append(pid)
        for name, pids in by_pool.items():
            if len(pids) == 1:
                self.terminate_node(pids[0])
                continue
            got = self.http.request("GET", self._gke_pool(name))
            instances = self._list_pool_instances(got)
            if instances is None:
                # No instance groups exposed: only the anonymous-shrink
                # single-node path exists.
                for pid in pids:
                    self.terminate_node(pid)
                continue
            names_sorted = sorted(instances)
            calls: dict[str, list[str]] = {}  # igm → instance urls
            for pid in pids:
                token = pid.split("#", 1)[1]
                entry = instances.get(token)
                if entry is None and token.isdigit():
                    # Legacy slot id: i-th instance in name order.
                    if int(token) < len(names_sorted):
                        entry = instances[names_sorted[int(token)]]
                if entry is None:
                    # Named instance already gone: the terminate already
                    # happened (retried call, provider restart).
                    self._nodes.pop(pid, None)
                    continue
                inst_url, igm = entry
                calls.setdefault(igm, []).append(inst_url)
            with self._pool_lock(name):
                for igm, urls in calls.items():
                    # tpulint: allow(blocking-under-lock reason=the batched deleteInstances must not interleave with a concurrent resize of the same pool - same critical section as the single-node path)
                    op = self.http.request(
                        "POST",
                        f"{igm}/deleteInstances",
                        {
                            "instances": urls,
                            "skipInstancesOnValidationError": True,
                        },
                    )
                    # tpulint: allow(blocking-under-lock reason=operation wait belongs to the same locked deleteInstances window as the call above)
                    self._wait_operation(op, "compute")
            for pid in pids:
                self._nodes.pop(pid, None)
        for pid in rest:
            self.terminate_node(pid)

    def non_terminated_nodes(self) -> dict[str, str]:
        """Authoritative membership from the API, label-filtered
        (reference: list_instances filter on ray cluster-name label,
        node.py:378). Instances in a terminal state are dropped;
        node_pool members are synthesized from pool size."""
        out: dict[str, str] = {}
        modes = {p.get("mode", "instance") for p in self.node_pools.values()}
        if "instance" in modes:
            flt = urllib.parse.quote(f"labels.ray-tpu-cluster={self.cluster}")
            page = ""
            while True:
                url = f"{self._zone_base}/instances?filter={flt}"
                if page:
                    url += f"&pageToken={page}"
                got = self.http.request("GET", url)
                for inst in got.get("items", []):
                    labels = inst.get("labels", {})
                    if labels.get("ray-tpu-cluster") != self.cluster:
                        continue
                    if inst.get("status") in _TERMINAL_STATES:
                        continue
                    out[inst["name"]] = labels.get("ray-tpu-node-type", "")
                page = got.get("nextPageToken", "")
                if not page:
                    break
        # node_pool members from the LIVE pool (instance names when the
        # pool exposes its instance groups, else synthesized slots), so
        # a restarted provider sees existing VMs instead of
        # re-adding (and later being unable to reap) them.
        for name, node_type in self._pool_types.items():
            got = self.http.request("GET", self._gke_pool(name))
            instances = self._list_pool_instances(got)
            if instances is not None:
                for inst in instances:
                    out[f"{name}#{inst}"] = node_type
            else:
                for i in range(self._pool_count(got)):
                    out[f"{name}#{i}"] = node_type
        return out

    def runtime_node_id(self, provider_node_id: str) -> str | None:
        """Map to the runtime node that registered from this VM: the
        node's labels carry the provider id (instance mode, GCE
        metadata → detect_labels) or the GCE instance name (node_pool
        mode). The node table is fetched once per cache window and
        indexed by label, not rescanned per provider id."""
        if self._runtime_lookup is not None:
            return self._runtime_lookup(provider_node_id)
        index = self._node_label_index()
        hit = index.get(provider_node_id)
        if hit is None and "#" in provider_node_id:
            # node_pool ids carry the instance name after '#'.
            hit = index.get(provider_node_id.split("#", 1)[1])
        return hit

    def _node_label_index(self) -> dict[str, str]:
        """provider-id-label / gce-instance-label → runtime node id,
        cached for node_table_cache_s (one head RPC per reconcile tick
        instead of one per tracked VM)."""
        now = time.monotonic()
        if now < self._label_index_expiry:
            return self._label_index
        try:
            from ray_tpu_torch import api as core_api

            rt = core_api._runtime
            if not rt.ready:
                return {}
            table = rt.run(rt.core.head.call("node_table"), 5)
        except Exception:  # noqa: BLE001 - mapping is best-effort
            logger.debug(
                "node-label index unavailable (head busy?); provider-id "
                "mapping degrades to unmapped this tick", exc_info=True,
            )
            return {}
        index: dict[str, str] = {}
        for nid, n in table.items():
            labels = n.get("labels", {})
            for key in ("ray-tpu-provider-id", "ray-tpu-gce-instance"):
                if labels.get(key):
                    index[labels[key]] = nid
        self._label_index = index
        self._label_index_expiry = now + self._node_cache_s
        return index
