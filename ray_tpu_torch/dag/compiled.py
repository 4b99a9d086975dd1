"""Compiled DAG: lower a node graph to static per-actor schedules over
shared-memory channels.

Mirrors the reference's compiled graphs (reference:
python/ray/dag/compiled_dag_node.py `CompiledDAG` :805, per-actor exec
loop `do_exec_tasks` :186, `execute()` :2546, `_execute_until` :2475;
op schedule dag_node_operation.py). The property preserved: after
compile there is **no task submission and no scheduler involvement** per
step — the driver writes the input channel, every actor spins in a
read→compute→write loop, and the driver reads the output channels.

In the port, a CUDA step stays on its device inside one actor. The
`collective` DAG nodes gather their payloads through the CPU collective
group (torch tensors cross it out of band and come back on the caller's
device) and reduce them with torch on that device; device tensors that
must not pass through the host move by tensor transport or a mesh
group's verbs. The host channels carry control-plane payloads and host
arrays, like the reference's shared-memory channels.
"""

from __future__ import annotations

import itertools
import os
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.collective.types import ReduceOp
from ray_tpu_torch.dag.channel import ChannelClosed, ShmChannel
from ray_tpu_torch.dag.node import (
    AttributeNode,
    ClassMethodNode,
    CollectiveNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
)

_dag_counter = itertools.count()


class _DagError:
    """Error value that flows through channels instead of raising
    mid-loop (reference: RayTaskError traveling through CompiledDAGRef)."""

    __slots__ = ("err",)

    def __init__(self, err: Exception):
        self.err = err


class CompiledDAGRef:
    """Future for one ``execute()`` call (reference:
    compiled_dag_ref.py)."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx

    def get(self, timeout: float | None = 30.0):
        return self._dag._result(self._idx, timeout)


class CompiledDAG:
    def __init__(
        self,
        root: DAGNode,
        *,
        buffer_size: int | None = None,
        max_buffered: int | None = None,
    ):
        from ray_tpu_torch.dag.context import DAGContext

        ctx = DAGContext.get()
        self.buffer_size = buffer_size or ctx.buffer_size
        self.nslots = max_buffered or ctx.max_buffered
        self.dag_id = f"dag{next(_dag_counter)}_{os.getpid()}"
        self.root = root
        self._exec_idx = 0
        self._read_idx = 0
        self._row: list = []
        self._cache: dict[int, Any] = {}
        self._torn_down = False
        self._compile()

    # ---------------------------------------------------------- compile
    def _compile(self):
        # 1. Topo-collect nodes.
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(n: DAGNode):
            if n.uid in seen:
                return
            seen.add(n.uid)
            for d in n.upstream():
                visit(d)
            order.append(n)

        visit(self.root)
        self.outputs = (
            list(self.root.args)
            if isinstance(self.root, MultiOutputNode)
            else [self.root]
        )

        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) > 1:
            raise ValueError("a DAG can have at most one InputNode")
        self.has_input = bool(inputs)

        # 2. Owner of every node: actor id for method/collective nodes,
        #    None = driver for input; attribute nodes live with their
        #    parent's owner (extraction happens reader-side, see _expr).
        owner: dict[int, str | None] = {}
        actors: dict[str, Any] = {}
        for n in order:
            if isinstance(n, (InputNode,)):
                owner[n.uid] = None
            elif isinstance(n, AttributeNode):
                owner[n.uid] = owner[n.parent.uid]
            elif isinstance(n, ClassMethodNode):
                owner[n.uid] = n.actor._actor_id
                actors[n.actor._actor_id] = n.actor
            elif isinstance(n, CollectiveNode):
                parent_owner = owner[n.parent.uid]
                if parent_owner is None:
                    raise ValueError(
                        "collective input must come from an actor node"
                    )
                owner[n.uid] = parent_owner
            elif isinstance(n, MultiOutputNode):
                owner[n.uid] = None
            else:
                raise TypeError(type(n).__name__)
        self._owner = owner
        self._actors = actors

        # 3. Find cross-owner edges → each producer node gets one channel
        #    with one reader rank per consuming owner. `_source` maps any
        #    node to the channel-producing node it aliases (attribute
        #    nodes read their parent's channel).
        def source(n: DAGNode) -> DAGNode:
            while isinstance(n, AttributeNode):
                n = n.parent
            return n

        consumers: dict[int, set[str | None]] = {}  # producer uid → owners
        for n in order:
            if isinstance(n, MultiOutputNode):
                continue
            for dep in n.upstream():
                src = source(dep)
                if owner[src.uid] != owner[n.uid]:
                    consumers.setdefault(src.uid, set()).add(owner[n.uid])
        for out in self.outputs:
            src = source(out)
            if owner[src.uid] is None and not isinstance(
                source(out), InputNode
            ):
                raise ValueError("DAG outputs must be actor-produced nodes")
            consumers.setdefault(src.uid, set()).add(None)

        # 4. Allocate channel files (driver creates; everyone opens).
        base = os.path.join(
            ray_tpu_torch.api._runtime.core.store.dir, "channels", self.dag_id
        )
        os.makedirs(base, exist_ok=True)
        self._chan_dir = base
        self._channels: dict[int, dict] = {}  # producer uid → spec
        node_by_uid = {n.uid: n for n in order}
        for uid, owners in consumers.items():
            readers = sorted(owners, key=lambda o: (o is None, o or ""))
            path = os.path.join(base, f"ch_{uid}")
            ShmChannel(
                path,
                writer=True,
                create=True,
                n_readers=len(readers),
                nslots=self.nslots,
                capacity=self.buffer_size,
            )
            self._channels[uid] = {
                "path": path,
                "readers": {o: r for r, o in enumerate(readers)},
                "producer": owner[uid],
            }

        # 5. Collective groups: one per op_id, ranks = bind order.
        groups: dict[int, list[str]] = {}  # op_id → actor ids in rank order
        for n in order:
            if isinstance(n, CollectiveNode):
                groups.setdefault(n.op_id, []).append(owner[n.uid])
        self._groups = {
            op_id: {
                "name": f"{self.dag_id}_col{op_id}",
                "members": members,
            }
            for op_id, members in groups.items()
        }

        # 6. Per-actor schedules in topo order.
        schedules: dict[str, list] = {a: [] for a in actors}
        for n in order:
            own = owner[n.uid]
            if own is None or isinstance(n, AttributeNode):
                continue
            if isinstance(n, ClassMethodNode):
                op = {
                    "kind": "method",
                    "uid": n.uid,
                    "method": n.method_name,
                    "args": [self._expr(a, own, node_by_uid) for a in n.args],
                    "kwargs": {
                        k: self._expr(v, own, node_by_uid)
                        for k, v in n.kwargs.items()
                    },
                }
            elif isinstance(n, CollectiveNode):
                g = self._groups[n.op_id]
                op = {
                    "kind": "collective",
                    "uid": n.uid,
                    "verb": n.kind,
                    "op": n.reduce_op.value,
                    "group": g["name"],
                    "rank": g["members"].index(own),
                    "world": len(g["members"]),
                    "perm": n.perm,
                    "args": [self._expr(n.parent, own, node_by_uid)],
                    "kwargs": {},
                }
            else:
                continue
            spec = self._channels.get(n.uid)
            op["write"] = (
                {"path": spec["path"]} if spec is not None else None
            )
            schedules[own].append(op)
        self._schedules = schedules

        # 7. Start actor loops: per actor, first a setup task (open
        #    channels + init collective groups), then the spinning loop.
        self._loop_refs = []
        for actor_id, schedule in schedules.items():
            handle = actors[actor_id]
            chan_specs = self._reader_specs(actor_id)
            group_specs = [
                {
                    "name": g["name"],
                    "world": len(g["members"]),
                    "rank": g["members"].index(actor_id),
                }
                for g in self._groups.values()
                if actor_id in g["members"]
            ]
            ref = _submit_system_task(
                handle,
                _dag_actor_loop,
                schedule,
                chan_specs,
                group_specs,
                self.nslots,
                self.buffer_size,
            )
            self._loop_refs.append(ref)

        # 8. Driver ends: input writer + output readers.
        if self.has_input:
            inp_uid = inputs[0].uid
            if inp_uid not in self._channels:
                raise ValueError("InputNode is never consumed by any actor")
            self._input_chan = ShmChannel(
                self._channels[inp_uid]["path"], writer=True
            )
        else:
            self._input_chan = None
        self._output_readers = []
        for out in self.outputs:
            src = source(out)
            spec = self._channels[src.uid]
            chan = ShmChannel(
                spec["path"], writer=False, rank=spec["readers"][None]
            )
            self._output_readers.append((chan, self._attr_chain(out)))

    def _expr(self, value, reader_owner, node_by_uid):
        """Encode an argument: const | read-from-channel | local value |
        input extraction. Attribute chains apply reader-side."""
        if not isinstance(value, DAGNode):
            return ("const", value)
        chain = self._attr_chain(value)
        src = value
        while isinstance(src, AttributeNode):
            src = src.parent
        if self._owner[src.uid] == reader_owner:
            return ("local", src.uid, chain)
        spec = self._channels[src.uid]
        return (
            "chan",
            src.uid,
            spec["path"],
            spec["readers"][reader_owner],
            chain,
            isinstance(src, InputNode),
        )

    @staticmethod
    def _attr_chain(n: DAGNode):
        chain = []
        while isinstance(n, AttributeNode):
            chain.append(n.key)
            n = n.parent
        chain.reverse()
        return chain

    def _reader_specs(self, actor_id):
        """All channels this actor reads, for the setup phase."""
        specs = []
        for uid, spec in self._channels.items():
            if actor_id in spec["readers"]:
                specs.append(
                    {
                        "uid": uid,
                        "path": spec["path"],
                        "rank": spec["readers"][actor_id],
                    }
                )
        return specs

    # ---------------------------------------------------------- execute
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("DAG has been torn down")
        if self._input_chan is not None:
            self._input_chan.write((args, kwargs))
        ref = CompiledDAGRef(self, self._exec_idx)
        self._exec_idx += 1
        return ref

    def _result(self, idx: int, timeout: float | None):
        while idx not in self._cache:
            # Resumable row: a timeout mid-row must not drop the reads
            # already done, or the output channels desynchronize.
            while len(self._row) < len(self._output_readers):
                chan, chain = self._output_readers[len(self._row)]
                v = chan.read(timeout=timeout)
                for key in chain:
                    if not isinstance(v, _DagError):
                        v = v[key]
                self._row.append(v)
            self._cache[self._read_idx] = self._row
            self._row = []
            self._read_idx += 1
        values = self._cache.pop(idx)
        for v in values:
            if isinstance(v, _DagError):
                raise v.err
        return values[0] if len(values) == 1 else values

    # --------------------------------------------------------- teardown
    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        if self._input_chan is not None:
            self._input_chan.close()
        for chan, _ in self._output_readers:
            chan.close()
        try:
            ray_tpu_torch.get(self._loop_refs, timeout=10)
        # tpulint: allow(broad-except reason=teardown join: loop actors may already be dead or killed, which is exactly what teardown wants)
        except Exception:  # noqa: BLE001 - actors may already be dead
            pass
        import shutil

        shutil.rmtree(self._chan_dir, ignore_errors=True)

    def __del__(self):
        try:
            self.teardown()
        # tpulint: allow(broad-except reason=__del__ during interpreter shutdown: modules may be half-torn-down and raising would print an unraisable-exception warning, not propagate)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


# ------------------------------------------------------- actor-side loop
def _submit_system_task(handle, fn, *args):
    """Run ``fn(instance, *args)`` as an actor task (the @sys: dispatch in
    core_worker._execute)."""
    from ray_tpu_torch.api import _submit_system_task as submit

    return submit(handle, fn, *args)


def _dag_actor_loop(
    instance, schedule, chan_specs, group_specs, nslots, buffer_size,
):
    """The compiled per-actor loop (reference: do_exec_tasks
    compiled_dag_node.py:186 — READ → COMPUTE → WRITE until teardown).
    Runs on the actor's execution thread; channel waits are busy-polls on
    shared memory, not RPCs.

    The reference's overlapped execution schedule
    (dag_node_operation.py:576-593) exists to hide NCCL transfer latency
    behind GPU compute. A host-thread equivalent (prefetch + writer
    threads around these channels) was built, benchmarked net-negative
    at BOTH small and 8 MiB payloads in the JAX package — the GIL
    serializes the copies with compute, and the ShmChannel ring already
    pipelines ACROSS actors — and deleted. Torch payloads of a
    collective node are reduced with torch on the caller's device."""
    import numpy as np

    import ray_tpu_torch.collective as col
    from ray_tpu_torch.collective.backends.cpu_group import (
        _REDUCERS,
        _array_split,
    )

    # setup: open read/write ends, init collective groups
    readers = {
        s["uid"]: ShmChannel(s["path"], writer=False, rank=s["rank"])
        for s in chan_specs
    }
    writers = {}
    for op in schedule:
        if op["write"] is not None:
            writers[op["uid"]] = ShmChannel(op["write"]["path"], writer=True)
    for g in group_specs:
        if not col.is_group_initialized(g["name"]):
            col.init_collective_group(
                g["world"], g["rank"], backend="cpu", group_name=g["name"]
            )

    # Channel-read order per iteration (deterministic): first use of each
    # channel in schedule order.
    read_order: list[int] = []
    for op in schedule:
        for e in list(op["args"]) + list(op["kwargs"].values()):
            if e[0] == "chan" and e[1] not in read_order:
                read_order.append(e[1])

    def ensure_read(expr, env):
        """Advance the channel cursor for this op's inputs BEFORE any
        fallible extraction: a failed attribute chain must not leave a
        channel unread for the iteration, or every later iteration pairs
        mismatched values across channels."""
        if expr[0] == "chan" and expr[1] not in env:
            env[expr[1]] = readers[expr[1]].read()

    def eval_arg(expr, env):
        kind = expr[0]
        if kind == "const":
            return expr[1]
        if kind == "local":
            _, uid, chain = expr
            v = env[uid]
        else:
            _, uid, _path, _rank, chain, is_input = expr
            v = env[uid]
            if is_input and not isinstance(v, _DagError):
                in_args, in_kwargs = v
                if chain:
                    key = chain[0]
                    v = in_kwargs[key] if isinstance(key, str) else in_args[key]
                    chain = chain[1:]
                else:
                    v = in_args[0] if len(in_args) == 1 else in_args
        for key in chain:
            if isinstance(v, _DagError):
                break
            v = v[key]
        return v

    def run_collective(op, value):
        """All collective verbs lower to allgather on the group, then a
        local reduce — error values gather like any payload, so a failed
        peer poisons the op instead of hanging it."""
        gathered = col.allgather(value, group_name=op["group"])
        # The CPU backend np.asarray-wraps payloads that are not torch
        # tensors; a _DagError comes back as a 0-d object array — unwrap
        # before the error scan.
        gathered = [
            g.item()
            if isinstance(g, np.ndarray) and g.dtype == object and g.ndim == 0
            else g
            for g in gathered
        ]
        err = next((g for g in gathered if isinstance(g, _DagError)), None)
        if err is not None:
            return err
        if op["verb"] == "allgather":
            return list(gathered)
        if op["verb"] == "permute":
            # P2P rank rotation (pipeline stage handoff). Payloads lower
            # via the gather (every value visible, pick my source); a
            # large device tensor moves through tensor transport or a
            # mesh group's permute instead.
            src = next(
                (s for s, d in op["perm"] if d == op["rank"]), None
            )
            return None if src is None else gathered[src]
        # Rank order, as the CPU group's hub reduces: torch tensors with
        # torch on the caller's device (the group returns the gathered
        # tensors there), numpy payloads with numpy.
        reduced = _REDUCERS[ReduceOp(op["op"])](gathered)
        if op["verb"] == "allreduce":
            return reduced
        return _array_split(reduced, op["world"])[op["rank"]]

    try:
        while True:
            env: dict[int, Any] = {}
            for op in schedule:
                for e in list(op["args"]) + list(op["kwargs"].values()):
                    ensure_read(e, env)  # ChannelClosed propagates
                try:
                    args = [eval_arg(e, env) for e in op["args"]]
                    kwargs = {
                        k: eval_arg(e, env) for k, e in op["kwargs"].items()
                    }
                    err = next(
                        (
                            a
                            for a in list(args) + list(kwargs.values())
                            if isinstance(a, _DagError)
                        ),
                        None,
                    )
                    if op["kind"] == "collective":
                        value = run_collective(op, args[0])
                    elif err is not None:
                        value = err
                    else:
                        value = getattr(instance, op["method"])(
                            *args, **kwargs
                        )
                except ChannelClosed:
                    raise
                # tpulint: allow(broad-except reason=the exception is captured as a typed _DagError and flows through the output channel to the caller, who re-raises it)
                except Exception as e:  # noqa: BLE001 - flows to output
                    value = _DagError(e)
                env[op["uid"]] = value
                w = writers.get(op["uid"])
                if w is not None:
                    w.write(value)
    except ChannelClosed:
        pass
    finally:
        for w in writers.values():
            w.close()
        for g in group_specs:
            try:
                col.destroy_collective_group(g["name"])
            # tpulint: allow(broad-except reason=loop teardown of per-execution groups; a poisoned or already-destroyed group raises typed errors with nothing left to clean)
            except Exception:  # noqa: BLE001
                pass
    return {"ok": True}
