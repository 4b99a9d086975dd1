"""Cross-language task API: call functions DEFINED in foreign workers.

Reference: python/ray/cross_language.py — ``ray.cross_language.
cpp_function("Plus").remote(1, 2)`` submits a task executed by a C++
worker whose binary registered ``Plus`` with RAY_REMOTE. Here C++
functions register via RAYTPU_REMOTE
(ray_tpu_torch/cpp/include/raytpu/ray_remote.h), the node manager spawns
the configured worker binary (config CPP_WORKER_CMD) for leases whose
runtime_env is ``{"language": "cpp"}``, and the task rides the NORMAL
submission path — ownership, leasing, retries — with fn_id
``cfn:<name>`` and msgpack-only arguments/results (pickle never
crosses the language boundary).

The other direction (C++ driver calling Python functions registered
with ``ray_tpu_torch._private.xlang.register_function``) lives in
ray_tpu_torch/cpp/src/client.cpp (Driver::Call).

Usage (``cpp_client.program`` builds the port's C++ sources with g++
at first use)::

    import ray_tpu_torch
    from ray_tpu_torch._native import cpp_client
    ray_tpu_torch.init(_system_config={
        "CPP_WORKER_CMD": str(cpp_client.program("raytpu_worker")),
    })
    add = ray_tpu_torch.cross_language.cpp_function("Add")
    assert ray_tpu_torch.get(add.remote(19, 23)) == 42
"""

from __future__ import annotations


class CppFunction:
    """Handle to a C++-registered remote function (by name)."""

    def __init__(
        self,
        name: str,
        *,
        resources: dict | None = None,
        max_retries: int = 3,
    ):
        if ":" in name:
            raise ValueError(
                f"cpp function names must not contain ':': {name!r}"
            )
        self._name = name
        self._resources = resources
        self._max_retries = max_retries

    def options(self, **opts) -> "CppFunction":
        allowed = {"resources", "max_retries"}
        bad = set(opts) - allowed
        if bad:
            raise TypeError(
                f"cpp_function options support {sorted(allowed)}; "
                f"got {sorted(bad)}"
            )
        merged = {
            "resources": self._resources,
            "max_retries": self._max_retries,
            **opts,
        }
        return CppFunction(self._name, **merged)

    def remote(self, *args):
        """Submit; returns an ObjectRef whose value is the function's
        msgpack result decoded to plain Python data."""
        from ray_tpu_torch import api

        out = api._runtime.run(
            api._runtime.core.submit_task(
                f"cfn:{self._name}",
                args,
                {},
                num_returns=1,
                resources=self._resources,
                max_retries=self._max_retries,
                runtime_env={"language": "cpp"},
            )
        )
        return out[0]


def cpp_function(name: str, **opts) -> CppFunction:
    """A handle to the C++ function registered as ``name`` in the
    cluster's configured worker binary (RAYTPU_REMOTE(name))."""
    return CppFunction(name, **opts)
