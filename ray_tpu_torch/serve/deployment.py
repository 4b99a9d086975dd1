"""@serve.deployment decorator and application graphs.

(reference: python/ray/serve/deployment.py Deployment / Application —
``.bind()`` builds a composition graph; serve.run deploys the whole
graph, injecting DeploymentHandles for bound children.)
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    config: DeploymentConfig = field(default_factory=DeploymentConfig)

    def options(
        self,
        *,
        name: str | None = None,
        num_replicas: int | None = None,
        max_ongoing_requests: int | None = None,
        request_timeout_s: float | None = None,
        drain_timeout_s: float | None = None,
        autoscaling_config: AutoscalingConfig | dict | None = None,
        ray_actor_options: dict | None = None,
        user_config: dict | None = None,
    ) -> "Deployment":
        cfg = replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if request_timeout_s is not None:
            if request_timeout_s <= 0:
                raise ValueError("request_timeout_s must be positive")
            cfg.request_timeout_s = request_timeout_s
        if drain_timeout_s is not None:
            if drain_timeout_s < 0:
                raise ValueError("drain_timeout_s must be >= 0")
            cfg.drain_timeout_s = drain_timeout_s
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if user_config is not None:
            cfg.user_config = user_config
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"deployment {self.name} cannot be called directly; "
            "deploy it with serve.run(<dep>.bind(...))"
        )


@dataclass
class Application:
    """A node in the bind graph; child Applications in the init args
    become DeploymentHandles at deploy time."""

    deployment: Deployment
    bind_args: tuple
    bind_kwargs: dict

    def walk(self):
        """Yield this node and all descendants (depth-first)."""
        yield self
        for a in list(self.bind_args) + list(self.bind_kwargs.values()):
            if isinstance(a, Application):
                yield from a.walk()
