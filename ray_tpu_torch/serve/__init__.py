"""ray_tpu_torch.serve: online model serving (controller / proxy / replica).

Capability-equivalent to the reference's Serve library (reference:
python/ray/serve/_private/controller.py:106 ServeController,
_private/replica.py:1139 Replica actors, handle.py:757 DeploymentHandle,
_private/proxy.py HTTP proxy, batching.py, multiplex.py), rebuilt on the
ray_tpu_torch actor runtime:

- ``@serve.deployment`` declares a deployment; ``.bind()`` composes an
  application graph whose child deployments are injected as handles.
- ``serve.run(app)`` starts (or reuses) the controller actor, which
  reconciles target replica counts, restarts dead replicas, and runs the
  autoscaling loop.
- ``DeploymentHandle.remote`` routes with power-of-two-choices over
  client-tracked in-flight counts (reference: request_router/).
- ``serve.start_http`` launches an HTTP proxy actor that maps routes to
  application ingress handles.

TPU twist: replicas are ordinary ray_tpu_torch actors, so a deployment can
reserve TPU chips per replica; a JAX model replica jits once in its
constructor and serves from device memory.
"""

from ray_tpu_torch.serve.api import (
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    run,
    scale,
    shutdown,
    start_grpc,
    start_http,
    status,
)
from ray_tpu_torch.serve.grpc_ingress import grpc_chat, grpc_request, grpc_stream
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig
from ray_tpu_torch.serve.context import get_multiplexed_model_id
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.serve.rpc_ingress import RpcIngressActor, rpc_request

__all__ = [
    "AutoscalingConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "RpcIngressActor",
    "grpc_chat",
    "grpc_request",
    "grpc_stream",
    "rpc_request",
    "run",
    "scale",
    "shutdown",
    "start_grpc",
    "start_http",
    "status",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu('serve')
del _rlu
