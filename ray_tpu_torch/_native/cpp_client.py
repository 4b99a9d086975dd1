"""The port's C++ client and worker (``ray_tpu_torch/cpp/``), built with
g++ at first use.

``libraytpu.a`` and its three programs (``raytpu_demo``,
``raytpu_worker``, ``raytpu_reconnect_probe``) are built into
``build/ray_tpu_torch/cpp-<hash>/``, with the flags of ``cpp/Makefile``.
The hash covers the flags and every header and source, so an edit
rebuilds and a stale build is never used. Several processes (or threads)
may build at once: each compiles into a directory of its own and renames
it into place; the first rename wins and the others drop theirs. Nothing
is built at import time; a failed build raises ``NativeBuildError``.

A driver of one's own builds against the library with
``build_program(source, out)``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ray_tpu_torch._native import BUILD_DIR, NativeBuildError

CPP_DIR = Path(__file__).resolve().parent.parent / "cpp"
INCLUDE_DIR = CPP_DIR / "include"
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra")
LIB_SOURCES = ("client.cpp", "transport.cpp", "worker.cpp")
# program -> (its source under cpp/src, the libraries it links)
PROGRAMS = {
    "raytpu_demo": ("demo.cpp", ("-ldl",)),
    "raytpu_worker": ("worker_main.cpp", ("-pthread", "-ldl")),
    "raytpu_reconnect_probe": ("reconnect_probe.cpp", ("-ldl",)),
}
LIBRARY = "libraytpu.a"


def build_dir() -> Path:
    """Where the build of the current sources goes (or went)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted((*INCLUDE_DIR.rglob("*.h"),
                        *(CPP_DIR / "src").glob("*.cpp"))):
        h.update(str(path.relative_to(CPP_DIR)).encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"cpp-{h.hexdigest()[:16]}"


def _complete(path: Path) -> bool:
    return all((path / name).is_file() for name in (LIBRARY, *PROGRAMS))


def _run_all(cmds: list[list[str]], what: str) -> None:
    """Run the commands at once; raise with the first failure's errors."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err[-4000:]}")
    if failed:
        raise NativeBuildError(f"g++ failed for {what}:\n" + failed[0])


def build() -> Path:
    """Build the library and its programs unless they are built already;
    returns the directory that holds them."""
    out = build_dir()
    if _complete(out):
        return out
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        inc = ["-I", str(INCLUDE_DIR)]
        objs = [tmp / f"{Path(s).stem}.o" for s in LIB_SOURCES]
        _run_all([["g++", *CXX_FLAGS, *inc, "-c", str(CPP_DIR / "src" / s),
                   "-o", str(o)] for s, o in zip(LIB_SOURCES, objs)],
                 LIBRARY)
        _run_all([["ar", "rcs", str(tmp / LIBRARY), *map(str, objs)]],
                 LIBRARY)
        _run_all([["g++", *CXX_FLAGS, *inc, str(CPP_DIR / "src" / src),
                   str(tmp / LIBRARY), "-o", str(tmp / name), *libs]
                  for name, (src, libs) in PROGRAMS.items()],
                 "the C++ programs")
        try:
            os.rename(tmp, out)
        except OSError:
            # Another process renamed its directory into place first.
            if not _complete(out):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def program(name: str) -> Path:
    """Path of one of the built programs (``PROGRAMS``), building first."""
    if name not in PROGRAMS:
        raise KeyError(f"no C++ program {name!r}; have {sorted(PROGRAMS)}")
    return build() / name


def build_program(source: str | os.PathLike, out: str | os.PathLike
                  ) -> Path:
    """Compile one C++ source (a driver of one's own, using
    ``raytpu/client.h``) against the library into ``out``."""
    lib = build() / LIBRARY
    out = Path(out)
    _run_all([["g++", *CXX_FLAGS, "-I", str(INCLUDE_DIR), str(source),
               str(lib), "-o", str(out), "-ldl"]], str(source))
    return out
