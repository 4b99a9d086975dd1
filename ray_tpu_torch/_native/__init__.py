"""Host-side native (C++) code of the port, built with g++ at first use.

Each library is compiled from sources under ``ray_tpu_torch/native/`` into
``build/ray_tpu_torch/lib<name>-<hash>.so`` at the repository root (the
directory the CUDA kernels build into, listed in ``.gitignore``). The hash
covers the sources and the flags, so an edited source is rebuilt and a
stale library is never loaded. It exposes a flat C interface for ctypes.
Nothing is built at import time; a failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ray_tpu_torch._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()  # one build at a time within a process


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((NATIVE_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: tuple[str, ...]) -> Path:
    """Compile ``sources`` (relative to ``ray_tpu_torch/native/``) into
    one shared library unless it is built already; returns its path.
    Several processes may build at once: each writes its own temporary
    file and renames it into place."""
    out = library_path(name, sources)
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, *(str(NATIVE_DIR / s) for s in sources),
               "-lpthread", "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ failed for {name}:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    return out
