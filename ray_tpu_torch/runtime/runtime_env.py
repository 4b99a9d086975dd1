"""Runtime environments beyond pip/uv: conda envs, containerized
workers, and the refcounted URI cache that garbage-collects
unreferenced builds.

Reference: python/ray/_private/runtime_env/conda.py (named env vs
yaml/dict spec → created env, worker python swapped), image_uri.py
(podman run of the worker command with the session mounted), and
uri_cache.py (size-capped cache, in-use URIs pinned, LRU eviction of
unreferenced entries) — the per-node runtime_env agent glues those
together; here the NodeManager plays that role directly.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import threading
import time


# ----------------------------------------------------------------- conda


def _conda_bin() -> str:
    conda = shutil.which("conda")
    if conda is None:
        raise RuntimeError(
            "runtime_env requested a conda env but no `conda` binary is "
            "on PATH of this node"
        )
    return conda


def build_conda_env(spec, root: str) -> str:
    """Materialize a ``conda:`` runtime env; returns the env's python.

    Accepted spec shapes (reference: conda.py get_conda_dict):
    - ``"envname"`` — a pre-existing named env; nothing is built.
    - ``"path/to/environment.yml"`` — created from that file.
    - ``{"dependencies": [...], ...}`` — env dict, written out and built.
    - ``["numpy", ...]`` — shorthand for ``{"dependencies": [...]}``.

    Built envs live at ``<root>/conda`` with a ``.ready`` marker, so a
    crash mid-build rebuilds from scratch (same protocol as the venv
    builder in node.py).
    """
    conda = _conda_bin()
    if isinstance(spec, str) and not spec.endswith((".yml", ".yaml")):
        # Pre-existing named env: resolve its interpreter through conda
        # itself (the env may live in any configured envs_dir).
        proc = subprocess.run(
            [conda, "run", "-n", spec, "python", "-c",
             "import sys; print(sys.executable)"],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"runtime_env conda env {spec!r} is not usable:\n"
                f"{proc.stderr[-2000:]}"
            )
        return proc.stdout.strip().splitlines()[-1]

    prefix = os.path.join(root, "conda")
    marker = os.path.join(prefix, ".ready")
    python = os.path.join(prefix, "bin", "python")
    if os.path.exists(marker):
        return python
    os.makedirs(root, exist_ok=True)
    shutil.rmtree(prefix, ignore_errors=True)
    if isinstance(spec, str):
        env_file = spec
    else:
        if isinstance(spec, (list, tuple)):
            spec = {"dependencies": list(spec)}
        env_file = os.path.join(root, "environment.yml")
        with open(env_file, "w") as f:
            # JSON is a YAML subset — no yaml dependency needed.
            json.dump(spec, f)
    proc = subprocess.run(
        [conda, "env", "create", "--prefix", prefix, "--file", env_file],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"runtime_env conda env create failed:\n{proc.stderr[-2000:]}"
        )
    if not os.path.exists(python):
        raise RuntimeError(
            f"conda env created at {prefix} but {python} does not exist"
        )
    with open(marker, "w") as f:
        f.write("ok")
    return python


# ------------------------------------------------------------- container


def container_engine() -> str | None:
    for engine in ("podman", "docker"):
        path = shutil.which(engine)
        if path:
            return path
    return None


def container_image(renv: dict) -> str | None:
    """The image a runtime_env requests, or None. Both reference
    shapes: ``image_uri: "img"`` and ``container: {"image": "img"}``."""
    spec = renv.get("container")
    if isinstance(spec, dict) and spec.get("image"):
        return spec["image"]
    return renv.get("image_uri")


def wrap_container_argv(
    renv: dict,
    argv: list[str],
    env: dict[str, str],
    mounts: list[str],
    workdir: str | None,
) -> list[str]:
    """Rewrite a worker command to run inside the requested image
    (reference: image_uri.py _modify_context — podman run with the
    session dir mounted and the worker env forwarded).

    ``--network host`` because the worker dials the head/node over
    loopback TCP; every mount is host-path == container-path so the
    PYTHONPATH and store paths the runtime computed stay valid inside.
    """
    engine = container_engine()
    if engine is None:
        raise RuntimeError(
            "runtime_env requested a container image but neither "
            "podman nor docker is on PATH of this node"
        )
    image = container_image(renv)
    spec = renv.get("container") or {}
    # The worker must run the IMAGE's interpreter: the host
    # sys.executable path does not exist inside (and is deliberately
    # not mounted — the image owns its python and site-packages).
    argv = [spec.get("worker_python", "python3"), *argv[1:]]
    cmd = [engine, "run", "--rm", "--network", "host"]
    seen: set[str] = set()
    for m in mounts:
        if m and m not in seen and os.path.exists(m):
            seen.add(m)
            cmd += ["-v", f"{m}:{m}"]
    for k, v in env.items():
        cmd += ["--env", f"{k}={v}"]
    if workdir:
        cmd += ["--workdir", workdir]
    cmd += list(spec.get("run_options", ()))
    cmd.append(image)
    cmd += argv
    return cmd


# --------------------------------------------------------------- GC cache


def _tree_bytes(root: str) -> int:
    total = 0
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                pass
    return total


def _foreign_live_refs(root: str) -> bool:
    """True if ANOTHER live process holds a pid-marker ref on this env
    root. Several node daemons can share one host cache
    (build_runtime_env's per-hash flock exists for exactly that), so
    this process's refcounts alone must never justify deleting the
    tree another daemon's workers run from."""
    refs_dir = os.path.join(root, ".refs")
    try:
        marks = os.listdir(refs_dir)
    except OSError:
        return False
    me = str(os.getpid())
    for mark in marks:
        if mark == me or not mark.isdigit():
            continue
        try:
            os.kill(int(mark), 0)
            return True  # foreign pid alive → pinned
        except ProcessLookupError:
            # Stale marker from a dead daemon: clean as we go.
            try:
                os.unlink(os.path.join(refs_dir, mark))
            except OSError:
                pass
        except PermissionError:
            return True  # alive under another uid
    return False


class UriCache:
    """Refcounted, byte-capped registry of built env roots (reference:
    uri_cache.py URICache — in-use URIs are pinned; once total size
    exceeds the cap, unreferenced entries evict oldest-idle-first).

    The NodeManager acquires an env when a worker spawns into it and
    releases on worker death; eviction forgets the entry (``on_evict``
    drops the build memo so nothing hands out the dying root), then
    deletes the tree on a background thread — a multi-GB conda env
    rmtree must not stall the node's event loop.

    Three guards against deleting an env someone still needs:
    - local refcounts (this daemon's live workers),
    - a per-root ``.refs/<pid>`` marker checked across processes
      (sibling daemons sharing the host cache),
    - ``min_idle_s``: an entry is only evictable after sitting
      unreferenced for a grace period, closing the build→spawn window
      where a fresh env has no ref yet.
    """

    def __init__(self, max_total_bytes: int, on_evict=None,
                 min_idle_s: float = 30.0, delete_fn=None):
        self.max_total_bytes = max_total_bytes
        self.min_idle_s = min_idle_s
        self._on_evict = on_evict
        # delete_fn(h, root) runs on the GC thread; the node passes one
        # that holds the per-hash build flock so a concurrent rebuild of
        # the same hash cannot interleave with the delete.
        self._delete_fn = delete_fn or (
            lambda _h, root: shutil.rmtree(root, ignore_errors=True)
        )
        self._lock = threading.Lock()
        # hash → {root, bytes, refs, last_used}
        self._entries: dict[str, dict] = {}

    def _pid_mark(self, root: str) -> str:
        return os.path.join(root, ".refs", str(os.getpid()))

    def register(self, h: str, root: str):
        if not h:
            return
        with self._lock:
            entry = self._entries.get(h)
            if entry is None or entry["root"] != root:
                self._entries[h] = {
                    "root": root,
                    "bytes": _tree_bytes(root),
                    "refs": 0,
                    "last_used": time.monotonic(),
                }

    def acquire(self, h: str):
        if not h:
            return
        with self._lock:
            entry = self._entries.get(h)
            if entry is None:
                return
            entry["refs"] += 1
            entry["last_used"] = time.monotonic()
            mark = self._pid_mark(entry["root"])
        try:
            os.makedirs(os.path.dirname(mark), exist_ok=True)
            with open(mark, "w"):
                pass
        except OSError:
            pass

    def release(self, h: str):
        if not h:
            return
        evicted: list[tuple[str, str]] = []
        with self._lock:
            entry = self._entries.get(h)
            if entry is not None:
                entry["refs"] = max(0, entry["refs"] - 1)
                entry["last_used"] = time.monotonic()
                if entry["refs"] == 0:
                    try:
                        os.unlink(self._pid_mark(entry["root"]))
                    except OSError:
                        pass
            evicted = self._evict_locked()
        for eh, _root in evicted:
            if self._on_evict:
                self._on_evict(eh)
        if evicted:
            threading.Thread(
                target=lambda: [
                    self._delete_fn(h, root) for h, root in evicted
                ],
                name="ray_tpu_torch-env-gc",
                daemon=True,
            ).start()

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e["bytes"] for e in self._entries.values())

    def refs(self, h: str) -> int:
        with self._lock:
            entry = self._entries.get(h)
            return entry["refs"] if entry else 0

    def _evict_locked(self) -> list[tuple[str, str]]:
        evicted = []
        now = time.monotonic()
        total = sum(e["bytes"] for e in self._entries.values())
        idle = sorted(
            (
                h
                for h, e in self._entries.items()
                if e["refs"] == 0 and now - e["last_used"] >= self.min_idle_s
            ),
            key=lambda h: self._entries[h]["last_used"],
        )
        for h in idle:
            if total <= self.max_total_bytes:
                break
            if _foreign_live_refs(self._entries[h]["root"]):
                continue
            entry = self._entries.pop(h)
            total -= entry["bytes"]
            evicted.append((h, entry["root"]))
        return evicted
