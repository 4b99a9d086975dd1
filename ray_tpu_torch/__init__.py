"""PyTorch + CUDA port of ray_tpu's LLM serving engine and training, on
one device or sharded over a mesh of ranks, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``llm/``, ``train/``, ``parallel/``) so
each module's counterpart is found at the same path. It imports torch, numpy and the
standard library only. Hand-written CUDA kernels live under ``csrc/`` and
are built with ``nvcc`` at first use (see ``_build.py``).

Entry points default to ``device="cuda"`` and raise when no GPU is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Turn ``device`` into a ``torch.device``; a CUDA device without a
    GPU raises instead of falling back to the CPU."""
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
