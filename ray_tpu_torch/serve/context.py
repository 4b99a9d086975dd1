"""Per-request context inside replicas.

(reference: python/ray/serve/context.py _serve_request_context)
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass, field


@dataclass
class RequestContext:
    request_id: str = ""
    multiplexed_model_id: str = ""
    route: str = ""
    app_name: str = ""
    # Deployment this request was routed to (the bounded label serve
    # telemetry keys its histograms/gauges by).
    deployment: str = ""


_request_context: contextvars.ContextVar[RequestContext] = (
    contextvars.ContextVar("serve_request_context", default=RequestContext())
)


def get_request_context() -> RequestContext:
    return _request_context.get()


def set_request_context(ctx: RequestContext):
    return _request_context.set(ctx)


def get_multiplexed_model_id() -> str:
    """Model id the current request was routed with (reference:
    serve.get_multiplexed_model_id, python/ray/serve/api.py)."""
    return _request_context.get().multiplexed_model_id
