"""serve public API: deployment / run / status / shutdown / proxy.

(reference: python/ray/serve/api.py — serve.deployment :246, serve.run
:686, serve.status, serve.delete, serve.shutdown; serve.start.)
"""

from __future__ import annotations

import logging
import time
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.serve.config import DeploymentConfig
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import CONTROLLER_NAME, DeploymentHandle

logger = logging.getLogger("ray_tpu_torch.serve")

PROXY_NAME = "_SERVE_PROXY"


def deployment(_func_or_class=None, **options) -> Deployment:
    """@serve.deployment / @serve.deployment(num_replicas=..., ...)."""

    def wrap(target):
        dep = Deployment(target, getattr(target, "__name__", "deployment"))
        if options:
            return dep.options(**options)
        return dep

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def _get_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return None


def _get_or_create_controller():
    handle = _get_controller()
    if handle is not None:
        return handle
    controller = (
        ray_tpu_torch.remote(ServeController)
        .options(
            name=CONTROLLER_NAME,
            lifetime="detached",
            max_concurrency=1000,
            num_cpus=0.1,
        )
        .remote()
    )
    # Fire-and-forget the reconciliation loop.
    controller.run_control_loop.remote()
    return controller


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: str | None = None,
    _blocking: bool = True,
    timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application graph and return the ingress handle."""
    if not isinstance(app, Application):
        raise TypeError("serve.run takes an Application (deployment.bind())")
    controller = _get_or_create_controller()

    # Flatten the bind graph; de-dupe deployments by name; replace child
    # Application args with DeploymentHandles.
    nodes = list(app.walk())
    seen: dict[str, Application] = {}
    for node in nodes:
        prev = seen.get(node.deployment.name)
        if prev is not None and prev is not node:
            raise ValueError(
                f"duplicate deployment name {node.deployment.name!r} in app"
            )
        seen[node.deployment.name] = node

    def materialize(value: Any):
        if isinstance(value, Application):
            return DeploymentHandle(value.deployment.name, name)
        return value

    deployments = []
    for node in seen.values():
        deployments.append(
            {
                "name": node.deployment.name,
                "callable": node.deployment.func_or_class,
                "init_args": tuple(materialize(a) for a in node.bind_args),
                "init_kwargs": {
                    k: materialize(v) for k, v in node.bind_kwargs.items()
                },
                "config": node.deployment.config.to_dict(),
            }
        )
    if route_prefix is None:
        route_prefix = "/" if name == "default" else f"/{name}"
    spec = {
        "route_prefix": route_prefix,
        "ingress": app.deployment.name,
        "deployments": deployments,
    }
    ray_tpu_torch.get(controller.deploy_application.remote(name, spec))

    if _blocking:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            st = ray_tpu_torch.get(controller.get_status.remote()).get(name, {})
            if st and all(d["status"] == "HEALTHY" for d in st.values()):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(f"application {name!r} not healthy in time")
    return DeploymentHandle(app.deployment.name, name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    if controller is None:
        raise RuntimeError("serve is not running")
    status_map = ray_tpu_torch.get(controller.get_status.remote())
    if name not in status_map:
        raise ValueError(f"no application named {name!r}")
    route_table = ray_tpu_torch.get(controller.get_route_table.remote())
    for _route, (app, ingress, *_rest) in route_table.items():
        if app == name:
            return DeploymentHandle(ingress, name)
    raise ValueError(f"application {name!r} has no ingress")


def get_deployment_handle(
    deployment_name: str, app_name: str = "default"
) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> dict:
    controller = _get_controller()
    if controller is None:
        return {}
    return ray_tpu_torch.get(controller.get_status.remote())


def scale(
    deployment_name: str, target: int, app_name: str = "default"
) -> int:
    """Set a deployment's target replica count directly (operator/bench
    entry point). Scale-down retires victims through the drain protocol
    — they stop accepting, finish in-flight requests, then exit — so
    this never drops a request. For autoscaled deployments the value is
    clamped to [min_replicas, max_replicas] and the policy loop keeps
    adjusting from it. Returns the applied target."""
    controller = _get_controller()
    if controller is None:
        raise RuntimeError("serve is not running")
    return ray_tpu_torch.get(
        controller.update_target.remote(app_name, deployment_name, target)
    )


def delete(name: str):
    controller = _get_controller()
    if controller is not None:
        ray_tpu_torch.get(controller.delete_application.remote(name))


def shutdown():
    controller = _get_controller()
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=10)
        except Exception:  # noqa: BLE001
            logger.debug(
                "graceful controller shutdown failed; killing it",
                exc_info=True,
            )
        ray_tpu_torch.kill(controller)
    from ray_tpu_torch.serve.grpc_ingress import GRPC_INGRESS_NAME

    for name in (PROXY_NAME, GRPC_INGRESS_NAME):
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
        except ValueError:
            pass
    # No deregistration wait is needed: kill synchronously marks the
    # actor DEAD at the head, and the head's get_actor treats DEAD as
    # not-found — a serve.run() issued right after shutdown() creates
    # a fresh controller instead of reviving the corpse.


def start_http(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the HTTP proxy actor; returns the bound port.

    (reference: per-node HTTPProxy actors, serve/_private/proxy.py:710 —
    here a single proxy actor is enough for one host.)"""
    from ray_tpu_torch.serve.proxy import ProxyActor

    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME)
    except ValueError:
        proxy = (
            ray_tpu_torch.remote(ProxyActor)
            .options(
                name=PROXY_NAME,
                lifetime="detached",
                max_concurrency=1000,
                num_cpus=0.1,
            )
            .remote(host, port)
        )
    return ray_tpu_torch.get(proxy.get_port.remote())


def start_grpc(
    host: str = "127.0.0.1", port: int = 0, require_auth: bool = False
) -> int:
    """Start the gRPC ingress actor; returns the bound port.

    (reference: serve/_private/proxy.py:534 gRPCProxy — the reference
    serves gRPC next to HTTP; clients consume
    ray_tpu_torch/serve/protos/serve.proto in any language.) With
    ``require_auth=True`` every non-Healthz call must carry the cluster
    token as ``authorization: Bearer <token>`` metadata."""
    from ray_tpu_torch.serve.grpc_ingress import GRPC_INGRESS_NAME, GrpcIngressActor

    try:
        ingress = ray_tpu_torch.get_actor(GRPC_INGRESS_NAME)
    except ValueError:
        ingress = (
            ray_tpu_torch.remote(GrpcIngressActor)
            .options(
                name=GRPC_INGRESS_NAME,
                lifetime="detached",
                max_concurrency=1000,
                num_cpus=0.1,
            )
            .remote(host, port, require_auth)
        )
    return ray_tpu_torch.get(ingress.get_port.remote())
