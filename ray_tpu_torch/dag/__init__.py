"""Compiled graphs: static DAGs of actor-method calls over shared-memory
channels and collective ops (reference: python/ray/dag + ray/experimental/channel).

Usage mirrors the reference:

    with InputNode() as inp:
        x = a.step.bind(inp)
        y = b.step.bind(x)
        dag = MultiOutputNode([y])
    cdag = dag.experimental_compile()
    ref = cdag.execute(v)
    out = ref.get()
    cdag.teardown()
"""

from ray_tpu_torch.dag.channel import ChannelClosed, ChannelTimeout, ShmChannel
from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.context import DAGContext
from ray_tpu_torch.dag.node import (
    AttributeNode,
    ClassMethodNode,
    CollectiveNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
    allgather,
    allreduce,
    permute,
    reducescatter,
)

__all__ = [
    "InputNode",
    "MultiOutputNode",
    "DAGNode",
    "ClassMethodNode",
    "AttributeNode",
    "CollectiveNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGContext",
    "ShmChannel",
    "ChannelClosed",
    "ChannelTimeout",
    "allreduce",
    "allgather",
    "permute",
    "reducescatter",
]
