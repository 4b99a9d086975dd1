"""Autoscaler (v2-style): poll demand → bin-pack → drive a node provider.

Reference architecture: python/ray/autoscaler/v2/autoscaler.py:50 polls
GcsAutoscalerStateManager, v2/scheduler.py bin-packs pending demand onto
node types, InstanceManager (v2/instance_manager/instance_manager.py:29)
drives cloud providers. GPU shape: a node type models one GPU VM (all
its cards); VMs sharing a ``slice`` label drain and reap as one unit.
``gcp.py`` also holds the GCE notice source the node daemon watches and
the REST transport that data/bigquery.py reads through.
"""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, NodeTypeConfig
from ray_tpu_torch.autoscaler.providers import (
    FakeNodeProvider,
    GkeGpuNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.scheduler import fit_demand

__all__ = [
    "Autoscaler",
    "FakeNodeProvider",
    "GkeGpuNodeProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "fit_demand",
]
