"""DAG node types for compiled graphs.

Mirrors the reference's DAG-building surface (reference:
python/ray/dag/dag_node.py, class_node.py `ClassMethodNode`,
input_node.py `InputNode`/`InputAttributeNode`, output_node.py
`MultiOutputNode`, collective_node.py `_CollectiveOperation` :22): actor
method handles gain ``.bind(...)`` which records an edge instead of
executing, and ``experimental_compile`` lowers the graph to a static
per-actor schedule over shared-memory / device channels.
"""

from __future__ import annotations

import itertools
from typing import Any

from ray_tpu_torch.collective.types import ReduceOp

_node_counter = itertools.count()


class DAGNode:
    def __init__(self, args: tuple = (), kwargs: dict | None = None):
        self.uid = next(_node_counter)
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        # transport hint for this node's output edge: "auto" | "shm" |
        # "collective" (reference: with_tensor_transport /
        # torch_tensor_type.py picking NCCL vs shared memory)
        self.transport = "auto"

    def upstream(self) -> list["DAGNode"]:
        deps = [a for a in self.args if isinstance(a, DAGNode)]
        deps += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return deps

    def with_tensor_transport(self, transport: str = "auto") -> "DAGNode":
        self.transport = transport
        return self

    # -- building sugar ------------------------------------------------
    def __getitem__(self, key):
        return AttributeNode(self, key)

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def execute(self, *args, **kwargs):
        """Eager execution of the whole graph (un-compiled path —
        reference: DAGNode.execute walks the graph with normal actor
        calls). Compiled execution lives on CompiledDAG."""
        return _eager(self, args, kwargs)


class InputNode(DAGNode):
    """Placeholder for the driver's ``execute(*args)`` payload. Used as a
    context manager like the reference's ``with InputNode() as inp:``."""

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class AttributeNode(DAGNode):
    """input[i] / input.key / node[i] extraction."""

    def __init__(self, parent: DAGNode, key: Any):
        super().__init__(args=(parent,))
        self.key = key

    @property
    def parent(self) -> DAGNode:
        return self.args[0]


class ClassMethodNode(DAGNode):
    def __init__(self, actor, method_name: str, args, kwargs):
        super().__init__(args=args, kwargs=kwargs)
        self.actor = actor
        self.method_name = method_name

    def __repr__(self):
        return f"ClassMethodNode({self.actor._class_name}.{self.method_name})"


class CollectiveNode(DAGNode):
    """Per-actor output of a DAG-level collective (reference:
    dag/collective_node.py:22 `_CollectiveOperation`). All peer nodes of
    one collective share an `op_id`; compile initializes one collective
    group per op across the participating actors."""

    def __init__(
        self,
        op_id: int,
        kind: str,
        parent: DAGNode,
        reduce_op,
        peers: int,
        perm: list[tuple[int, int]] | None = None,
    ):
        super().__init__(args=(parent,))
        self.op_id = op_id
        self.kind = kind
        self.reduce_op = reduce_op
        self.peers = peers
        self.perm = perm

    @property
    def parent(self) -> DAGNode:
        return self.args[0]


class MultiOutputNode(DAGNode):
    def __init__(self, outputs):
        super().__init__(args=tuple(outputs))


_collective_counter = itertools.count()


class _CollectiveVerb:
    def __init__(self, kind: str):
        self.kind = kind

    def bind(self, nodes, op=ReduceOp.SUM):
        """nodes: one ClassMethodNode per participating actor; returns the
        same number of CollectiveNodes, rank = list position."""
        nodes = list(nodes)
        actors = set()
        for n in nodes:
            if not isinstance(n, ClassMethodNode):
                raise TypeError(
                    "collective.bind takes actor-method nodes, got "
                    f"{type(n).__name__}"
                )
            if n.actor._actor_id in actors:
                raise ValueError(
                    "collective across two nodes on the same actor"
                )
            actors.add(n.actor._actor_id)
        op_id = next(_collective_counter)
        return [
            CollectiveNode(op_id, self.kind, n, ReduceOp(op), len(nodes))
            for n in nodes
        ]


allreduce = _CollectiveVerb("allreduce")
allgather = _CollectiveVerb("allgather")
reducescatter = _CollectiveVerb("reducescatter")


class _PermuteVerb(_CollectiveVerb):
    """Point-to-point rank rotation as a DAG node — the
    collective_permute channel for pipeline-parallel stage handoff
    (reference: NCCL P2P channels nccl_group.py; TPU-native equivalent
    is lax.ppermute over ICI — XlaMeshGroup.permute). Each node's output
    is the value sent by its source rank in ``perm`` (None if no edge
    targets it)."""

    def __init__(self):
        super().__init__("permute")

    def bind(self, nodes, perm: list[tuple[int, int]]):
        bound = super().bind(nodes)
        perm = [(int(s), int(d)) for s, d in perm]
        world = len(bound)
        for s, d in perm:
            if not (0 <= s < world and 0 <= d < world):
                raise ValueError(f"perm edge {(s, d)} outside 0..{world-1}")
        if len({d for _s, d in perm}) != len(perm):
            raise ValueError("permute: a rank receives from two sources")
        for n in bound:
            n.perm = perm
        return bound


permute = _PermuteVerb()


def _eager(node: DAGNode, exec_args: tuple, exec_kwargs: dict):
    """Recursive eager interpretation (no channels): one actor call per
    method node."""
    import ray_tpu_torch

    memo: dict[int, Any] = {}

    def resolve(n):
        if not isinstance(n, DAGNode):
            return n
        if n.uid in memo:
            return memo[n.uid]
        if isinstance(n, InputNode):
            value = exec_args[0] if len(exec_args) == 1 else exec_args
        elif isinstance(n, AttributeNode):
            parent = resolve(n.parent)
            if isinstance(n.parent, InputNode) and isinstance(n.key, int):
                value = exec_args[n.key]
            elif isinstance(n.key, str) and isinstance(n.parent, InputNode):
                value = exec_kwargs[n.key]
            else:
                value = parent[n.key]
        elif isinstance(n, ClassMethodNode):
            args = [resolve(a) for a in n.args]
            kwargs = {k: resolve(v) for k, v in n.kwargs.items()}
            ref = getattr(n.actor, n.method_name).remote(*args, **kwargs)
            value = ray_tpu_torch.get(ref)
        elif isinstance(n, MultiOutputNode):
            value = [resolve(a) for a in n.args]
        elif isinstance(n, CollectiveNode):
            raise TypeError(
                "collective nodes require experimental_compile()"
            )
        else:
            raise TypeError(f"cannot eager-execute {type(n).__name__}")
        memo[n.uid] = value
        return value

    return resolve(node)
