"""PyTorch + CUDA port of ray_tpu: the distributed runtime (tasks, actors,
objects, placement groups) with the GPU as a scheduled resource, the LLM
serving engine and training, on one device or sharded over a mesh of
ranks, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout (``api.py``, ``runtime/``, ``ops/``, ``models/``, ``llm/``,
``train/``, ``parallel/``) so each module's counterpart is found at the
same path. It imports torch, numpy and the standard library only, and
torch only where a module computes: the runtime's own modules and this
package root import it lazily, so a worker that runs no torch code never
loads it. Hand-written CUDA kernels live under ``csrc/`` and are built
with ``nvcc`` at first use (see ``_build.py``).

Entry points default to ``device="cuda"`` and raise when no GPU is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

from __future__ import annotations

from ray_tpu_torch.version import __version__

__all__ = ["__version__", "resolve_device", "mesh_size"]


def resolve_device(device):
    """Turn ``device`` (a string or ``torch.device``) into a
    ``torch.device``; a CUDA device without a GPU raises instead of
    falling back to the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def mesh_size(mesh) -> int:
    """Number of devices in ``mesh`` (None is one device). Takes an object
    with a ``size`` attribute or method, as a JAX mesh or a torch
    ``DeviceMesh`` has."""
    if mesh is None:
        return 1
    size = mesh.size
    return int(size() if callable(size) else size)


def __getattr__(name):
    # Lazy-load the core API so `import ray_tpu_torch.models` does not drag
    # in the runtime (and vice versa).
    _core_api = {
        "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
        "broadcast", "kill", "cancel", "get_actor", "method", "ObjectRef",
        "ObjectRefGenerator", "available_resources", "cluster_resources",
        "nodes",
    }
    if name in _core_api:
        try:
            import ray_tpu_torch.api as _api
        except ImportError as e:
            raise AttributeError(
                f"ray_tpu_torch.{name} requires the core runtime "
                f"(ray_tpu_torch.api), which failed to import: {e}"
            ) from e
        return getattr(_api, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
