"""Accelerator plugin registry (reference:
python/ray/_private/accelerators/ — `AcceleratorManager` ABC
accelerator.py:18 with per-vendor managers; get_all_accelerator_managers
drives node resource detection)."""

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

_MANAGERS: list[AcceleratorManager] = [GPUAcceleratorManager()]


def register(manager: AcceleratorManager) -> None:
    """Add a vendor manager (user plugins for other accelerators)."""
    _MANAGERS.append(manager)


def all_managers() -> list[AcceleratorManager]:
    return list(_MANAGERS)


def detect_accelerator_resources() -> dict[str, float]:
    """{resource_name: count} across every registered manager."""
    out: dict[str, float] = {}
    for mgr in _MANAGERS:
        n = mgr.detect_count()
        if n:
            out[mgr.resource_name()] = float(n)
    return out


def detect_accelerator_labels() -> dict[str, str]:
    out: dict[str, str] = {}
    for mgr in _MANAGERS:
        out.update(mgr.detect_labels())
    return out


__all__ = [
    "AcceleratorManager",
    "GPUAcceleratorManager",
    "register",
    "all_managers",
    "detect_accelerator_resources",
    "detect_accelerator_labels",
]
