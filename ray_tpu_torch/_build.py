"""Build the CUDA kernels under ``csrc/`` with nvcc; load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/ray_tpu_torch/lib<name>-<hash>.so``
at the repository root (a directory ``.gitignore`` lists), compiled for
``sm_90a`` with a plain C interface. The hash covers the kernel sources
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built at import time: :func:`load` builds on first use,
and :func:`build` compiles several sources at once, one nvcc each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ray_tpu_torch._native import BUILD_DIR

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("paged_attention", "flash_fwd", "flash_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Element-type codes of the C entry points (csrc/common.cuh, rtt::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()  # one build at a time within a process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME); the CUDA kernels of "
        "ray_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all
    nvcc processes at once. Returns nvcc's output (register and shared
    memory use from ``-Xptxas -v``) per source built; raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """Load the library of kernel ``name``, building it first if needed
    (callers cache the bound function)."""
    with _lock:
        path = library_path(name)
        if not path.exists():
            build((name,))
    return ctypes.CDLL(str(path))


def dtype_code(dtype: torch.dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {dtype}"
        )
    return code


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
