"""DAG execution knobs (reference: python/ray/dag/context.py
`DAGContext` — buffer size, max buffered results, timeouts). Values
resolve through the central config registry at CONSTRUCTION time, so
``init(_system_config=...)`` overrides apply even when this module was
imported earlier."""

from __future__ import annotations

from dataclasses import dataclass, field


def _cfg(name: str):
    from ray_tpu_torch._private import config

    return config.get(name)


@dataclass
class DAGContext:
    buffer_size: int = field(
        default_factory=lambda: _cfg("DAG_BUFFER_SIZE")
    )
    max_buffered: int = field(
        default_factory=lambda: _cfg("DAG_MAX_BUFFERED")
    )
    submit_timeout: float = field(
        default_factory=lambda: _cfg("DAG_SUBMIT_TIMEOUT")
    )
    get_timeout: float = field(
        default_factory=lambda: _cfg("DAG_GET_TIMEOUT")
    )

    _instance = None

    @classmethod
    def get(cls) -> "DAGContext":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance
