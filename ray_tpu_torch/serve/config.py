"""Deployment and autoscaling configuration.

(reference: python/ray/serve/config.py AutoscalingConfig /
DeploymentConfig; schema.py)
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AutoscalingConfig:
    """Scale replicas to hold per-replica ongoing requests near target
    (reference: serve/_private/autoscaling_state.py decision logic)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 5
    # Proxy-enforced deadline for requests routed to this deployment
    # (None → proxy default, 60s). For unary requests this bounds the
    # whole call; for streaming responses it is a per-item idle deadline
    # (the gap between yields), not an end-to-end cap. Reference:
    # Serve's request_timeout_s in HTTPOptions (serve/config.py).
    request_timeout_s: float | None = None
    # Scale-down drain bound for this deployment's replicas: a retiring
    # replica stops accepting, finishes in-flight requests up to this
    # long, then is killed (None → SERVE_DRAIN_TIMEOUT_S). Reference:
    # Serve's graceful_shutdown_timeout_s (serve/config.py).
    drain_timeout_s: float | None = None
    autoscaling_config: AutoscalingConfig | None = None
    ray_actor_options: dict = field(default_factory=dict)
    user_config: dict | None = None

    def to_dict(self) -> dict:
        return {
            "num_replicas": self.num_replicas,
            "max_ongoing_requests": self.max_ongoing_requests,
            "request_timeout_s": self.request_timeout_s,
            "drain_timeout_s": self.drain_timeout_s,
            "autoscaling": None
            if self.autoscaling_config is None
            else vars(self.autoscaling_config),
            "ray_actor_options": dict(self.ray_actor_options),
            "user_config": self.user_config,
        }
