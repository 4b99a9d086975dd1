"""The port's runtime core is a copy of the JAX package's: hold each
copied module to its source, and each ported one to its source outside
the functions that carry the device.

A copied module's syntax tree, docstrings removed, must equal its
source's after the package rename (``ray_tpu`` -> ``ray_tpu_torch`` in
imports and in strings that name the package or its paths; the
``RAY_TPU_*`` environment names stay). A ported module may differ only in
the top-level names listed for it below. The set of ``ray_tpu_torch``
modules the copies import but that do not exist yet is pinned: a later
slice that adds one shrinks it.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SRC, PORT = REPO / "ray_tpu", REPO / "ray_tpu_torch"
RENAME = re.compile(r"\bray_tpu\b")
RENAME_BACK = re.compile(r"^ray_tpu_torch\b")

COPIED = (
    "exceptions.py",
    "version.py",
    "_private/__init__.py",
    "_private/ids.py",
    "_private/config.py",
    "_private/rpc.py",
    "_private/test_utils.py",
    "_private/accelerators/accelerator.py",
    "collective/types.py",
    "runtime/__init__.py",
    "runtime/agent.py",
    "runtime/core_worker.py",
    "runtime/drain.py",
    "runtime/head.py",
    "runtime/head_storage.py",
    "runtime/object_store.py",
    "runtime/runtime_env.py",
    "runtime/transfer.py",
    "runtime/worker_main.py",
    "util/__init__.py",
    "util/metrics.py",
    "util/rpdb.py",
    "util/scheduling_strategies.py",
)

# module -> (reason, top-level names that may differ). A name is a def or
# class, an assigned name, or "import <module>" for an import statement.
PORTED = {
    "__init__.py": (
        "the package root also holds the port's device helpers, which "
        "import torch lazily",
        {"*"},
    ),
    "_private/serialization.py": (
        "torch tensors cross the object store as flat bytes with dtype, "
        "shape and device",
        {"import sys", "_tensor_types", "_reduce_tensor", "_rebuild_tensor",
         "_Pickler", "serialize"},
    ),
    "_private/sanitize.py": (
        "the jax compile watch and host-sync tracer have no counterpart",
        {"_COMPILE_GRACE_DEFAULT", "_RECOMPILES_TOTAL", "compile_grace",
         "_recompile_counter", "_sig_one", "_signature", "_sig_diff",
         "WatchedJit", "_norm_argnums", "_norm_argnames", "watch_jit",
         "_jax_watch_count", "_ORIG_JAX_JIT", "_ORIG_BLOCK_UNTIL_READY",
         "_ORIG_DEVICE_GET", "_BACKEND_COMPILE_EVENT", "_backend_compiles",
         "_compile_monitor_registered", "_register_compile_monitor",
         "_SYNC_RING_MAX", "_sync_guard", "_sync_intervals",
         "_patched_jax_jit", "_record_sync", "_timed_sync",
         "take_host_sync_intervals", "jax_watch_active",
         "install_jax_watch", "uninstall_jax_watch",
         "maybe_install_jax_watch", "reset"},
    ),
    "_private/usage.py": (
        "the usage record's device probe reads torch.cuda, not jax",
        {"usage_stats"},
    ),
    "_private/accelerators/__init__.py": (
        "the registry holds the GPU manager in place of the TPU one",
        {"import ray_tpu_torch._private.accelerators.tpu",
         "import ray_tpu_torch._private.accelerators.gpu", "_MANAGERS",
         "__all__"},
    ),
    "_native/shmstore.py": (
        "the port's build_library takes sources under ray_tpu_torch/native/",
        {"_load"},
    ),
    "collective/__init__.py": (
        "AUTO picks the multi-device backend from torch.cuda's device count",
        {"_resolve_backend"},
    ),
    "runtime/node.py": (
        "node labels come from the accelerator registry only: no GCE "
        "metadata probe over the network",
        {"detect_labels", "_gce_metadata_labels"},
    ),
    "runtime/memory.py": (
        "the memory plane samples the CUDA caching allocator, in a process "
        "that already holds a CUDA context only",
        {"import sys", "DEVICE_HBM_GB", "is_resource_exhausted",
         "tag_arrays", "_leaves", "_cuda", "_device_stats",
         "_live_array_bytes", "device_capacity_bytes", "oom_report"},
    ),
    "util/tracing.py": (
        "jax_profile becomes torch_profile (torch.profiler, Chrome trace)",
        {"jax_profile", "torch_profile"},
    ),
    "api.py": (
        "num_gpus maps to the GPU resource, as num_tpus maps to TPU",
        {"_normalize_options"},
    ),
    "placement.py": (
        "a slice's bundles hold GPUs",
        {"slice_placement_group"},
    ),
}

# ray_tpu_torch modules the copies import (at top level or lazily) that the
# port does not have yet; each raises ModuleNotFoundError where reached.
MISSING = {
    "ray_tpu_torch._private.lint",
    "ray_tpu_torch.autoscaler",
    "ray_tpu_torch.checkpoint",
    "ray_tpu_torch.collective.algo",
    "ray_tpu_torch.collective.backends",
    "ray_tpu_torch.dag",
    "ray_tpu_torch.serve",
    "ray_tpu_torch.train.profile",
    "ray_tpu_torch.train.session",
}


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _key(node: ast.stmt) -> str:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        target = node.targets[0]
        if isinstance(target, ast.Name):
            return target.id
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return node.target.id
    if isinstance(node, ast.Import):
        return "import " + ",".join(a.name for a in node.names)
    if isinstance(node, ast.ImportFrom):
        return f"import {node.module}"
    return ast.dump(node)


def _statements(text: str) -> list[tuple[str, str]]:
    tree = _strip_docstrings(ast.parse(text))
    return [(_key(node), ast.dump(node)) for node in tree.body]


def _source(rel: str) -> str:
    return RENAME.sub("ray_tpu_torch", (SRC / rel).read_text())


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_its_source(rel):
    want = ast.dump(_strip_docstrings(ast.parse(_source(rel))))
    got = ast.dump(_strip_docstrings(ast.parse((PORT / rel).read_text())))
    assert got == want, f"{rel} differs from ray_tpu/{rel} beyond the rename"


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_ported_module_differs_only_where_listed(rel):
    reason, names = PORTED[rel]
    assert reason
    want, got = _statements(_source(rel)), _statements(
        (PORT / rel).read_text())
    assert want != got, f"{rel} equals its source: list it as copied"
    if names == {"*"}:
        return
    keep = [kv for kv in want if kv[0] not in names]
    assert [kv for kv in got if kv[0] not in names] == keep, (
        f"{rel} differs from its source outside {sorted(names)}")
    # Every listed name differs, so the list stays as tight as the port.
    for name in names:
        assert ([d for k, d in want if k == name]
                != [d for k, d in got if k == name]), (
            f"{rel}: {name} is listed but equals its source")


def _module_exists(mod: str) -> bool:
    path = REPO.joinpath(*mod.split("."))
    return path.with_suffix(".py").is_file() or (path / "__init__.py").is_file()


def _is_module(mod: str) -> bool:
    """``mod`` is a module of the port, or of the JAX package under its
    old name (a module the port has yet to get)."""
    return _module_exists(mod) or _module_exists(RENAME_BACK.sub("ray_tpu",
                                                                 mod))


def _imported_modules(path: Path):
    """ray_tpu_torch modules an import statement in ``path`` names: the
    module of ``from m import x``, and ``m.x`` where that is a module."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for alias in node.names:
                if _is_module(f"{node.module}.{alias.name}"):
                    yield f"{node.module}.{alias.name}"


def test_missing_modules_are_pinned():
    missing = set()
    for rel in (*COPIED, *PORTED):
        for mod in _imported_modules(PORT / rel):
            if mod.split(".")[0] != "ray_tpu_torch":
                continue
            parts = mod.split(".")
            # The outermost package that does not exist names the gap.
            for i in range(2, len(parts) + 1):
                prefix = ".".join(parts[:i])
                if not _module_exists(prefix):
                    missing.add(prefix)
                    break
    assert missing == MISSING


def test_every_copy_and_port_is_listed_once():
    assert not set(COPIED) & set(PORTED)
    for rel in (*COPIED, *PORTED):
        assert (PORT / rel).is_file(), rel
        assert (SRC / rel).is_file(), rel
    # The shared-memory store's C++ source is copied byte for byte.
    assert ((PORT / "native/shmstore/shmstore.cpp").read_bytes()
            == (REPO / "native/shmstore/shmstore.cpp").read_bytes())


def test_comments_state_no_tpu_figure():
    """Docstrings and comments of the port's ported modules may say GPU
    where the source says TPU, but state no TPU time, rate or size."""
    figure = re.compile(r"\bv[456][a-z]*\b.*\d+(\.\d+)?\s*(GB|GiB|ms|s)\b")
    for rel in PORTED:
        text = (PORT / rel).read_text()
        for line in text.splitlines():
            assert not figure.search(line), f"{rel}: {line.strip()}"
