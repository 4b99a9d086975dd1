"""Public core API: init / remote / get / put / wait / actors.

Mirrors the reference's Python surface (reference:
python/ray/_private/worker.py `init` :1412, `get` :2846, `put` :3015;
python/ray/remote_function.py:314 `_remote`; python/ray/actor.py) over the
ray_tpu_torch runtime. All public calls are synchronous wrappers around the
runtime's asyncio loop, which runs on a background thread in the driver
and on the main thread in workers.
"""

from __future__ import annotations

import asyncio
import atexit
import functools
import os
import threading
from typing import Any, Sequence

from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.runtime.core_worker import ActorSubmitTarget, CoreWorker

_DEFAULT_TIMEOUT = None


class _Runtime:
    def __init__(self):
        self.loop: asyncio.AbstractEventLoop | None = None
        self.thread: threading.Thread | None = None
        self.head = None
        self.node = None
        self.core: CoreWorker | None = None
        self.mode: str | None = None
        self.session: str | None = None

    @property
    def ready(self) -> bool:
        return self.core is not None

    def run(self, coro, timeout=None):
        if self.loop is None:
            raise RayTpuError("ray_tpu_torch.init() has not been called")
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout
        )


_runtime = _Runtime()


def is_initialized() -> bool:
    return _runtime.ready


def _print_worker_log(msg: dict) -> None:
    """Render a worker-log pubsub record on the driver's stdout with the
    reference's "(prefix pid=N, node)" framing."""
    import sys as _sys

    data = msg.get("data", "")
    prefix = (
        f"({msg.get('worker_id', '?')[:8]} pid={msg.get('pid')}, "
        f"node={str(msg.get('node_id', '?'))[:8]})"
    )
    out = "".join(
        f"{prefix} {line}\n" for line in data.splitlines() if line.strip()
    )
    if out:
        _sys.stdout.write(out)
        _sys.stdout.flush()


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    resources: dict | None = None,
    object_store_dir: str | None = None,
    observer: bool = False,
    labels: dict | None = None,
    _system_config: dict | None = None,
) -> dict:
    """Start (or connect to) a cluster and attach this process as driver.

    With no ``address``, starts an in-process head service plus a node
    manager for this host (reference: ray.init head path, worker.py:1412 →
    node.py start_head_processes :1316). ``address="ray://host:port"``
    attaches as a REMOTE CLIENT driver (reference: Ray Client,
    python/ray/util/client/): no local node joins the cluster — leases go
    through the head and large puts upload to a cluster node.
    """
    if _runtime.ready:
        raise RayTpuError("ray_tpu_torch is already initialized")
    if _system_config:
        # Typed overrides of the config registry (reference:
        # ray.init(_system_config=...) threaded through the GCS); the
        # env export makes spawned workers inherit them.
        from ray_tpu_torch._private import config as _config

        _config.set_system_config(_system_config)
    if address is None:
        # Job drivers launched by the job manager inherit the cluster
        # address (reference: RAY_ADDRESS env for `ray job submit`
        # entrypoints).
        from ray_tpu_torch._private import config as _config

        address = _config.get("ADDRESS") or None
    client = False
    if address is not None and address.startswith("ray://"):
        client = True
        address = address[len("ray://"):]
    if observer and address is None:
        # Validate before the loop thread / head service start so a bad
        # call leaks nothing.
        raise RayTpuError("observer=True requires address=")
    if client and not address:
        raise RayTpuError("client mode requires ray://host:port")

    loop = asyncio.new_event_loop()
    thread = threading.Thread(
        target=loop.run_forever, name="ray_tpu_runtime", daemon=True
    )
    thread.start()
    _runtime.loop = loop
    _runtime.thread = thread

    async def _bootstrap():
        from ray_tpu_torch.runtime.head import HeadService
        from ray_tpu_torch.runtime.node import NodeManager, detect_resources
        from ray_tpu_torch.runtime.object_store import default_store_dir

        session = JobID.random().hex()[:12]
        if address is None:
            # Library-embedded heads journal only when HEAD_JOURNAL is
            # set: the ephemeral session store dir is rmtree'd at
            # shutdown, so a journal there would cost a write per
            # mutation and never be replayable. CLI/daemon heads (whose
            # session dir persists) journal by default (daemon.py).
            head = HeadService()
            head_addr = await head.start()
        else:
            head = None
            head_addr = address

        if client:
            # Client drivers keep a PRIVATE store dir (pull cache): the
            # cluster's stores live on its nodes.
            import tempfile

            store_dir = object_store_dir or os.path.join(
                tempfile.gettempdir(), f"ray_tpu_torch-client-{session}"
            )
        else:
            store_dir = object_store_dir or default_store_dir(session)
        if observer or client:
            # Read-only connection (CLI/dashboard) or remote client: no
            # schedulable node, no worker pool — the cluster must not
            # see this process as capacity (reference: `ray status`
            # attaches without adding a raylet; Ray Client drivers).
            node = None
        else:
            total = detect_resources()
            if num_cpus is not None:
                total["CPU"] = float(num_cpus)
            total.update(resources or {})
            node = NodeManager(
                head_addr, store_dir, resources=total, labels=labels
            )
            await node.start()

        core = CoreWorker(
            mode="client" if client else "driver",
            head_addr=head_addr,
            node_addr=node.addr if node else "",
            store_dir=store_dir,
        )
        await core.start()
        if not observer:
            from ray_tpu_torch._private import config as _config

            if _config.get("LOG_TO_DRIVER"):
                # Stream worker stdout/stderr to this driver (reference:
                # print_worker_logs worker.py:2295 — the log monitor
                # publishes, every driver prints).
                await core.subscribe("logs", _print_worker_log)
        return head, node, core, session, head_addr

    head, node, core, session, head_addr = _runtime.run(_bootstrap())
    _runtime.head = head
    _runtime.node = node
    _runtime.core = core
    _runtime.mode = "client" if client else "driver"
    _runtime.session = session
    atexit.register(shutdown)
    # tpulint: allow(TPU703 reason=opt-in telemetry gate is deliberately env-only — unset means provably nothing leaves the machine, no config layer can flip it)
    if os.environ.get("RAY_TPU_USAGE_REPORT_URL"):
        # Opt-in usage POST (reference: usage_lib report on init) —
        # fire-and-forget off-thread, never on the init path.
        from ray_tpu_torch._private import usage

        threading.Thread(
            target=usage.report_if_enabled, daemon=True
        ).start()
    return {
        "address": head_addr,
        "session": session,
        "node_id": node.node_id if node else None,
    }


def shutdown() -> None:
    if not _runtime.ready:
        return

    async def _teardown():
        await _runtime.core.stop()
        if _runtime.node is not None:
            await _runtime.node.stop()
        if _runtime.head is not None:
            await _runtime.head.stop()

    try:
        _runtime.run(_teardown(), timeout=10)
    # tpulint: allow(broad-except reason=shutdown is best-effort by contract; a half-dead runtime loop must not prevent the store destroy and process exit below)
    except Exception:  # noqa: BLE001
        pass
    if _runtime.mode in ("driver", "client"):
        # Driver (observer, client) sessions own their store dir; worker
        # processes share their node's and must not delete it.
        _runtime.core.store.destroy()
    def _drain_and_stop():
        # Cancel stragglers (serve demand reporters, pollers), then stop
        # only after their CancelledErrors have actually been delivered
        # (gather resolves post-delivery) — stopping in the same
        # iteration would leave them pending and still emit "Task was
        # destroyed but it is pending!" at interpreter exit.
        stragglers = list(asyncio.all_tasks(_runtime.loop))
        for task in stragglers:
            task.cancel()

        async def _finish():
            await asyncio.gather(*stragglers, return_exceptions=True)
            _runtime.loop.stop()

        asyncio.ensure_future(_finish())
        # Bounded drain: a straggler that absorbs cancellation must not
        # hold the loop (and the join below) hostage.
        _runtime.loop.call_later(3.0, _runtime.loop.stop)

    _runtime.loop.call_soon_threadsafe(_drain_and_stop)
    _runtime.thread.join(timeout=5)
    _runtime.__init__()


def _attach_worker(core: CoreWorker, loop: asyncio.AbstractEventLoop):
    """Called by worker_main so tasks can use the public API re-entrantly."""
    _runtime.loop = loop
    _runtime.core = core
    _runtime.mode = "worker"


# ----------------------------------------------------------------- refs
class ObjectRef:
    """A reference to a (possibly pending) object; carries its owner's
    address so any holder can resolve it (ownership model, SURVEY.md §5)."""

    __slots__ = ("hex", "owner_addr")

    def __init__(self, hex_id: str, owner_addr: str | None):
        self.hex = hex_id
        self.owner_addr = owner_addr

    def __reduce__(self):
        return (ObjectRef, (self.hex, self.owner_addr))

    def __hash__(self):
        return hash(self.hex)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.hex == self.hex

    def __repr__(self):
        return f"ObjectRef({self.hex[:12]}…@{self.owner_addr})"


# ----------------------------------------------------------- task verbs
def put(value: Any) -> ObjectRef:
    return _runtime.run(_runtime.core.put(value))


def broadcast(
    ref: "ObjectRef",
    timeout: float | None = None,
    strict: bool = True,
    return_details: bool = False,
):
    """Relay-broadcast a store-resident object into every node's store
    (reference: put-then-fan-out rides push_manager.h:28 chunked pushes;
    here waves of node prefetches double the source set each round).
    Returns the number of nodes that newly pulled a copy (nodes already
    holding one don't count). Later ``get``s on those nodes hit their
    local store instead of the owner.

    With ``strict`` (default), a node that could not be reached raises
    ObjectLostError naming it — callers relying on every-node locality
    must not silently proceed without it. ``strict=False`` returns the
    partial count instead. ``return_details`` returns the full reply
    dict (nodes/cached/failed/waves) instead of the count."""
    reply = _runtime.run(
        _runtime.core.broadcast_object(ref, timeout), timeout
    )
    if strict and reply.get("failed"):
        from ray_tpu_torch.exceptions import ObjectLostError

        raise ObjectLostError(
            f"broadcast incomplete ({reply['nodes']} pulled, "
            f"{len(reply['failed'])} failed): {reply['failed']}"
        )
    return reply if return_details else reply["nodes"]


def get(refs, timeout: float | None = _DEFAULT_TIMEOUT):
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    if not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("ray_tpu_torch.get() takes an ObjectRef or a list of them")
    values = _runtime.run(_runtime.core.get(refs, timeout))
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
):
    return _runtime.run(
        _runtime.core.wait(list(refs), num_returns, timeout)
    )


def kill(actor: "ActorHandle") -> None:
    _runtime.run(_runtime.core.kill_actor(actor._actor_id, actor._addr))


def cancel(ref: ObjectRef, *, force: bool = False) -> bool:
    """Cancel the NORMAL task producing ``ref`` (reference: ray.cancel,
    worker.py). Queued tasks fail fast; running tasks are force-killed
    at the worker (sync execution threads cannot be interrupted — the
    non-force SIGINT path of the reference has no safe analogue here, so
    ``force`` is accepted for API compatibility but both modes kill).
    Returns True if a pending/running task was cancelled; False when the
    task already finished — or when ``ref`` belongs to an ACTOR method
    (actor tasks are not cancellable here; kill the actor instead)."""

    async def do():
        core = _runtime.core
        if ref.owner_addr in (None, core.addr):
            return await core.cancel_task(ref.hex)
        conn = await core._connect(ref.owner_addr)
        reply = await conn.call("cancel_task", oid_hex=ref.hex)
        return bool(reply.get("ok"))

    return _runtime.run(do())


def available_resources() -> dict:
    table = _runtime.run(_runtime.core.head.call("node_table"))
    out: dict[str, float] = {}
    for node in table.values():
        for k, v in node["available"].items():
            out[k] = out.get(k, 0) + v
    return out


def cluster_resources() -> dict:
    table = _runtime.run(_runtime.core.head.call("node_table"))
    out: dict[str, float] = {}
    for node in table.values():
        for k, v in node["resources"].items():
            out[k] = out.get(k, 0) + v
    return out


def nodes() -> list[dict]:
    """Cluster node table: id, address, resources, labels (reference:
    ray.nodes())."""
    table = _runtime.run(_runtime.core.head.call("node_table"))
    return [
        {
            "node_id": nid,
            "addr": n["addr"],
            "resources": n["resources"],
            "available": n["available"],
            "labels": n.get("labels", {}),
            "alive": True,
        }
        for nid, n in table.items()
    ]


# ------------------------------------------------------------- @remote
def _caller_trace_ctx(name: str):
    """Capture the trace context on the CALLER's thread (a driver-side
    tracing.span scope lives in a thread-local that the runtime loop
    cannot see)."""
    from ray_tpu_torch.util import tracing

    return tracing.make_trace_ctx(name)


def _placement_tuple(pg, bundle_index: int):
    if pg is None:
        return None
    return (pg.bundle_node_addr(bundle_index), pg.id, bundle_index)


def _resolve_strategy(strategy, pg, pg_bundle):
    """scheduling_strategy option → (placement_group, bundle, wire spec).
    PlacementGroupSchedulingStrategy folds into the existing placement
    path; affinity/label strategies become a lease-time spec (reference:
    python/ray/util/scheduling_strategies.py)."""
    if strategy is None or strategy == "DEFAULT":
        return pg, pg_bundle, None
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
        to_scheduling_spec,
    )

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return (
            strategy.placement_group,
            strategy.placement_group_bundle_index,
            None,
        )
    return pg, pg_bundle, to_scheduling_spec(strategy)


class ObjectRefGenerator:
    """Iterates a streaming task's yields as they arrive (reference:
    python/ray/_private/object_ref_generator.py:32 ObjectRefGenerator).
    Yields ObjectRefs whose values are already local; works as a sync
    iterator from driver code and an async iterator on the runtime loop.
    """

    def __init__(self, task_id: str):
        self._task_id = task_id
        self._closed = False

    def close(self):
        """Stop consuming: undelivered items are dropped and the producer
        is told to stop at its next report."""
        if self._closed:
            return
        self._closed = True
        # May run from __del__ during interpreter shutdown: never block
        # on a loop that is gone (run_coroutine_threadsafe on a stopped
        # loop would hang forever).
        if (
            _runtime.core is None
            or _runtime.loop is None
            or not _runtime.loop.is_running()
        ):
            return
        try:
            fut = asyncio.run_coroutine_threadsafe(
                _runtime.core.close_generator(self._task_id), _runtime.loop
            )
            # On the runtime loop's own thread (async consumers / GC
            # there), blocking would deadlock the loop — fire and forget.
            if threading.current_thread() is not _runtime.thread:
                fut.result(timeout=2)
        # tpulint: allow(broad-except reason=generator close is best-effort cleanup; the runtime loop may already be stopped and the task gone — both fine outcomes of closing)
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass

    def __del__(self):
        try:
            self.close()
        # tpulint: allow(broad-except reason=__del__ during interpreter teardown must never raise; close() already degrades gracefully while alive)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        entry = _runtime.run(
            _runtime.core.next_generator_item(self._task_id)
        )
        return self._unwrap(entry, StopIteration)

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        entry = await _runtime.core.next_generator_item(self._task_id)
        return self._unwrap(entry, StopAsyncIteration)

    def _unwrap(self, entry, stop_exc):
        kind = entry[0]
        if kind == "done":
            raise stop_exc
        if kind == "error":
            raise entry[1]
        return ObjectRef(entry[1], _runtime.core.addr)


class RemoteFunction:
    def __init__(
        self,
        fn,
        *,
        num_returns=1,
        resources=None,
        max_retries=3,
        placement_group=None,
        placement_group_bundle_index=0,
        runtime_env=None,
        scheduling_strategy=None,
    ):
        self._fn = fn
        self._num_returns = num_returns
        self._resources = resources
        self._max_retries = max_retries
        self._pg = placement_group
        self._pg_bundle = placement_group_bundle_index
        self._runtime_env = runtime_env
        self._strategy = scheduling_strategy
        functools.update_wrapper(self, fn)

    def options(self, **opts):
        opts = _normalize_options(opts)
        merged = {
            "num_returns": self._num_returns,
            "resources": self._resources,
            "max_retries": self._max_retries,
            "placement_group": self._pg,
            "placement_group_bundle_index": self._pg_bundle,
            "runtime_env": self._runtime_env,
            "scheduling_strategy": self._strategy,
        }
        merged.update(opts)
        return RemoteFunction(self._fn, **merged)

    def remote(self, *args, **kwargs):
        pg, pg_bundle, scheduling = _resolve_strategy(
            self._strategy, self._pg, self._pg_bundle
        )
        out = _runtime.run(
            _runtime.core.submit_task(
                self._fn,
                args,
                kwargs,
                num_returns=self._num_returns,
                resources=self._resources,
                max_retries=self._max_retries,
                placement=_placement_tuple(pg, pg_bundle),
                runtime_env=self._runtime_env,
                scheduling=scheduling,
                trace_ctx=_caller_trace_ctx(self.__name__),
            )
        )
        if self._num_returns == "streaming":
            return ObjectRefGenerator(out)
        return out[0] if self._num_returns == 1 else out

    def __call__(self, *a, **kw):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; "
            "use .remote()"
        )


class ActorMethod:
    def __init__(
        self,
        handle: "ActorHandle",
        name: str,
        num_returns=1,
        tensor_transport=None,
    ):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._tensor_transport = tensor_transport

    _UNSET = object()

    def options(self, *, num_returns=_UNSET, tensor_transport=_UNSET):
        """``tensor_transport``: keep this method's return value in the
        actor's device-tensor store and move it point-to-point to
        consumers — True for direct rpc fetch, or a collective group
        name to ride that group's send/recv data plane (reference:
        tensor_transport on actor methods, gpu_object_manager/).
        Unspecified options keep their current values (chainable)."""
        num_returns = (
            self._num_returns if num_returns is self._UNSET else num_returns
        )
        tensor_transport = (
            self._tensor_transport
            if tensor_transport is self._UNSET
            else tensor_transport
        )
        if num_returns == "streaming" and tensor_transport is not None:
            raise ValueError(
                "tensor_transport does not compose with streaming "
                "generators: yielded items go through the normal "
                "result path"
            )
        return ActorMethod(
            self._handle, self._name, num_returns, tensor_transport
        )

    def remote(self, *args, **kwargs):
        target = ActorSubmitTarget(self._handle._actor_id, self._handle._addr)
        out = _runtime.run(
            _runtime.core.submit_task(
                self._name,
                args,
                kwargs,
                num_returns=self._num_returns,
                actor=target,
                tensor_transport=self._tensor_transport,
                trace_ctx=_caller_trace_ctx(self._name),
            )
        )
        if self._num_returns == "streaming":
            return ObjectRefGenerator(out)
        return out[0] if self._num_returns == 1 else out

    def bind(self, *args, **kwargs):
        """Record a compiled-graph edge instead of executing (reference:
        dag building via actor.method.bind, python/ray/dag/class_node.py)."""
        from ray_tpu_torch.dag.node import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: str, addr: str, class_name: str = ""):
        self._actor_id = actor_id
        self._addr = addr
        self._class_name = class_name

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._addr, self._class_name))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id[:12]}…)"


class ActorClass:
    def __init__(
        self,
        cls,
        *,
        resources=None,
        name=None,
        detached=False,
        placement_group=None,
        placement_group_bundle_index=0,
        max_concurrency=None,
        max_restarts=0,
        runtime_env=None,
        scheduling_strategy=None,
    ):
        self._cls = cls
        self._resources = resources
        self._name = name
        self._detached = detached
        self._pg = placement_group
        self._pg_bundle = placement_group_bundle_index
        self._max_concurrency = max_concurrency
        self._max_restarts = max_restarts
        self._runtime_env = runtime_env
        self._strategy = scheduling_strategy

    def options(self, *, lifetime=None, **opts):
        opts = _normalize_options(opts)
        merged = {
            "resources": self._resources,
            "name": self._name,
            "detached": (lifetime == "detached") or self._detached,
            "placement_group": self._pg,
            "placement_group_bundle_index": self._pg_bundle,
            "max_concurrency": self._max_concurrency,
            "max_restarts": self._max_restarts,
            "runtime_env": self._runtime_env,
            "scheduling_strategy": self._strategy,
        }
        merged.update(opts)
        return ActorClass(self._cls, **merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        pg, pg_bundle, scheduling = _resolve_strategy(
            self._strategy, self._pg, self._pg_bundle
        )
        actor_id, addr = _runtime.run(
            _runtime.core.create_actor(
                self._cls,
                args,
                kwargs,
                name=self._name,
                resources=self._resources,
                detached=self._detached,
                placement=_placement_tuple(pg, pg_bundle),
                max_concurrency=self._max_concurrency,
                max_restarts=self._max_restarts,
                runtime_env=self._runtime_env,
                scheduling=scheduling,
            )
        )
        return ActorHandle(actor_id, addr, self._cls.__name__)


def _normalize_options(options: dict) -> dict:
    """Translate ray-style num_cpus/num_gpus into the resources dict."""
    resources = dict(options.pop("resources", None) or {})
    if "num_cpus" in options:
        resources["CPU"] = float(options.pop("num_cpus"))
    if "num_gpus" in options:
        resources["GPU"] = float(options.pop("num_gpus"))
    if resources:
        options["resources"] = resources
    renv = options.get("runtime_env")
    if renv:
        # Fail bad specs HERE at submission — an invalid env otherwise
        # travels through scheduling and fails per lease attempt deep
        # in the node's locked env builder.
        exclusive = [k for k in ("pip", "uv", "conda") if renv.get(k)]
        if len(exclusive) > 1:
            raise ValueError(
                f"runtime_env: {exclusive} are mutually exclusive — "
                "specify one package manager, not both"
            )
        has_image = bool(renv.get("image_uri")) or bool(
            isinstance(renv.get("container"), dict)
            and renv["container"].get("image")
        )
        if has_image and exclusive:
            # A host-built venv/conda interpreter does not exist inside
            # the image; bake deps into the image instead (reference:
            # image_uri envs exclude pip/conda the same way).
            raise ValueError(
                f"runtime_env: 'container'/'image_uri' cannot combine "
                f"with {exclusive} — install packages in the image"
            )
    return options


def remote(*args, **options):
    """@ray_tpu_torch.remote decorator for functions and classes."""
    options = _normalize_options(options)

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, **options)
        return RemoteFunction(target, **options)

    if len(args) == 1 and not options and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("use @remote or @remote(**options)")
    return wrap


def _submit_system_task(handle: "ActorHandle", fn, *args) -> ObjectRef:
    """Run ``fn(instance, *args)`` as an actor task — the ``@sys:``
    dispatch in core_worker._execute. Shared by compiled graphs and the
    experimental collective API."""
    fn_id = _runtime.run(_runtime.core.export_function(fn))
    target = ActorSubmitTarget(handle._actor_id, handle._addr)
    refs = _runtime.run(
        _runtime.core.submit_task(
            f"@sys:{fn_id}", args, {}, num_returns=1, actor=target
        )
    )
    return refs[0]


def get_actor(name: str) -> ActorHandle:
    reply = _runtime.run(_runtime.core.head.call("get_actor", name=name))
    if not reply["ok"]:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(reply["actor_id"], reply["addr"], reply["class_name"])


def method(**kwargs):
    """Decorator stub for per-method options (reference: ray.method)."""

    def deco(fn):
        return fn

    return deco
