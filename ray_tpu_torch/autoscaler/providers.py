"""Node providers: how the autoscaler actually adds/removes capacity.

Reference: autoscaler node providers (aws/gcp/kuberay under
python/ray/autoscaler/_private and v2/instance_manager); tests use a fake
provider (reference: cluster_utils.py:26 AutoscalingCluster). Here the
fake provider starts real NodeManager daemons in-process — the same
multi-raylet-on-one-host strategy the reference test suite uses. A node
type with a GPU resource is then a real node whose leases open the card.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any


class NodeProvider:
    """ABC: create/terminate cluster nodes of a given node type."""

    def create_node(self, node_type: str, resources: dict) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def terminate_nodes(self, provider_node_ids: "list[str]") -> None:
        """Terminate a batch in one shot — the autoscaler reaps a
        fully-drained slice through this so providers with a unit-level
        API (queued resources, MIG deleteInstances) tear the slice down
        as ONE call. Default: per-node teardown."""
        for pid in provider_node_ids:
            self.terminate_node(pid)

    def non_terminated_nodes(self) -> dict[str, str]:
        """provider_node_id → node_type."""
        raise NotImplementedError

    def runtime_node_id(self, provider_node_id: str) -> str | None:
        """Map a provider node to the runtime node_id it registered as."""
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Launch NodeManager daemons inside the driver's runtime loop."""

    def __init__(self):
        from ray_tpu_torch import api as core_api

        self._rt = core_api._runtime
        self._nodes: dict[str, dict] = {}  # pid → {node, type}

    def create_node(self, node_type: str, resources: dict) -> str:
        from ray_tpu_torch.runtime.node import NodeManager

        rt = self._rt

        async def launch():
            node = NodeManager(
                rt.core.head_addr,
                rt.core.store.dir.as_posix(),
                resources=dict(resources),
            )
            await node.start()
            return node

        node = self._rt.run(launch())
        pid = f"fake-{uuid.uuid4().hex[:8]}"
        self._nodes[pid] = {"node": node, "type": node_type}
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        rec = self._nodes.pop(provider_node_id, None)
        if rec is None:
            return
        self._rt.run(rec["node"].stop())

    def non_terminated_nodes(self) -> dict[str, str]:
        return {pid: rec["type"] for pid, rec in self._nodes.items()}

    def runtime_node_id(self, provider_node_id: str) -> str | None:
        rec = self._nodes.get(provider_node_id)
        return rec["node"].node_id if rec else None


# The real GCE/GKE GPU provider lives in its own module (REST
# transport, operation polling, fixtures); re-exported here beside the
# fake one, as the JAX package re-exports its TPU provider. (The package
# __init__ imports this module eagerly, so a lazy shim would buy
# nothing.)
from ray_tpu_torch.autoscaler.gcp import GkeGpuNodeProvider  # noqa: E402,F401
