"""AcceleratorManager ABC (reference:
python/ray/_private/accelerators/accelerator.py:18 — per-vendor
detection, visibility envs, and labels behind one interface)."""

from __future__ import annotations


class AcceleratorManager:
    """One per vendor. Detection must be PASSIVE (env vars, devfs) —
    never initialize a device runtime in the node daemon (grabbing the
    chip there would starve the processes that need it)."""

    def resource_name(self) -> str:
        """Scheduler resource name, e.g. "GPU"."""
        raise NotImplementedError

    def detect_count(self) -> int:
        """Number of visible accelerators on this host (0 when absent)."""
        raise NotImplementedError

    def detect_labels(self) -> dict[str, str]:
        """Topology labels for the node (slice name, worker id, ...)."""
        return {}
