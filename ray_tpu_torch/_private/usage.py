"""Usage reporting (reference: python/ray/_private/usage/usage_lib.py —
cluster metadata + feature-usage tags collected at runtime, written to
the session dir, and POSTed to a collector unless disabled).

TPU-native stance: reporting is **opt-in** (the reference is opt-out):
nothing leaves the machine unless RAY_TPU_USAGE_REPORT_URL is set. The
record is always collected locally though — `usage_stats()` feeds the
dashboard/state API, and the session-dir file gives operators the same
artifact the reference writes (usage_stats.json).
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time

_lib_usages: set[str] = set()


def record_library_usage(name: str) -> None:
    """Tag a subsystem as used this session (reference:
    record_library_usage — serve/train/tune/data call it on import)."""
    _lib_usages.add(name)


def usage_stats() -> dict:
    """The full usage record (schema_version'd like the reference)."""
    from ray_tpu_torch.version import __version__

    record = {
        "schema_version": "0.1",
        "ray_tpu_version": __version__,
        "python_version": sys.version.split()[0],
        "os": platform.system().lower(),
        "collected_at": time.time(),
        "libraries": sorted(_lib_usages),
    }
    # Device info is recorded ONLY if this process already holds a CUDA
    # context. Probing otherwise would create one here, holding memory on
    # the card in the head daemon, which must leave it to the workers
    # (accelerators/gpu.py detects cards without CUDA for the same
    # reason).
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        record["torch_version"] = torch_mod.__version__
        try:
            if torch_mod.cuda.is_initialized():  # probing is free
                record["backend"] = "cuda"
                record["device_count"] = torch_mod.cuda.device_count()
                record["device_kind"] = torch_mod.cuda.get_device_name(0)
        # tpulint: allow(broad-except reason=device probe for optional usage fields; a failing probe just omits them from the record)
        except Exception:  # noqa: BLE001
            pass
    try:
        from ray_tpu_torch import api as core_api

        rt = core_api._runtime
        if rt.ready:
            table = rt.run(rt.core.head.call("node_table"), 5)
            record["cluster_nodes"] = len(table)
            totals: dict[str, float] = {}
            for n in table.values():
                for k, v in n.get("resources", {}).items():
                    totals[k] = totals.get(k, 0) + v
            record["cluster_resources"] = totals
    # tpulint: allow(broad-except reason=cluster-shape probe for optional usage fields; a process without a cluster simply reports none)
    except Exception:  # noqa: BLE001 - no cluster is fine
        pass
    return record


def write_usage_file(session_dir: str) -> str:
    """Drop usage_stats.json in the session dir (local artifact only)."""
    path = os.path.join(session_dir, "usage_stats.json")
    with open(path, "w") as f:
        json.dump(usage_stats(), f, indent=2)
    return path


def report_if_enabled(timeout: float = 5.0) -> bool:
    """POST the record to RAY_TPU_USAGE_REPORT_URL. OPT-IN: with the
    env var unset (the default) this is a no-op and nothing ever
    leaves the machine. Returns whether a report was sent."""
    # tpulint: allow(TPU703 reason=opt-in telemetry gate is deliberately env-only — unset means provably nothing leaves the machine, no config layer can flip it)
    url = os.environ.get("RAY_TPU_USAGE_REPORT_URL", "")
    if not url:
        return False
    import urllib.request

    data = json.dumps(usage_stats()).encode()
    req = urllib.request.Request(
        url,
        data=data,
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout):
            return True
    except OSError:
        return False  # best-effort: never fail the caller
