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
    "_private/tls_utils.py",
    "dashboard.py",
    "_private/ids.py",
    "_private/config.py",
    "_private/rpc.py",
    "_private/test_utils.py",
    "_private/accelerators/accelerator.py",
    "_private/xlang.py",
    "_private/lint/__init__.py",
    "_private/lint/__main__.py",
    "_private/lint/baseline.py",
    "_private/lint/dataflow.py",
    "_private/lint/pass_async_locks.py",
    "_private/lint/pass_collective.py",
    "_private/lint/pass_exceptions.py",
    "_private/lint/pass_handles.py",
    "_private/lint/pass_journal.py",
    "_private/lint/pass_lock_alias.py",
    "_private/lint/pass_locks.py",
    "_private/lint/pass_metric_schema.py",
    "_private/lint/pass_pairing.py",
    "_private/lint/pass_pubsub.py",
    "_private/lint/pass_rank_flow.py",
    "_private/lint/pass_rpc.py",
    "_private/lint/pass_rpc_contract.py",
    "_private/lint/protocol.py",
    "cross_language.py",
    "autoscaler/autoscaler.py",
    "autoscaler/scheduler.py",
    "checkpoint/__init__.py",
    "checkpoint/erasure.py",
    "checkpoint/fork.py",
    "checkpoint/remote.py",
    "checkpoint/store.py",
    "collective/backends/__init__.py",
    "dag/__init__.py",
    "dag/channel.py",
    "dag/context.py",
    "dag/node.py",
    "collective/flight_recorder.py",
    "data/__init__.py",
    "data/bigquery.py",
    "data/dataset.py",
    "data/datasource.py",
    "data/delta.py",
    "data/executor.py",
    "data/plan.py",
    "experimental/__init__.py",
    "experimental/tensor_transport.py",
    "experimental/tqdm_ray.py",
    "llm/batch.py",
    "llm/serve_integration.py",
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
    "serve/__init__.py",
    "serve/api.py",
    "serve/batching.py",
    "serve/config.py",
    "serve/context.py",
    "serve/deployment.py",
    "serve/grpc_ingress.py",
    "serve/handle.py",
    "serve/multiplex.py",
    "serve/protos/__init__.py",
    "serve/protos/serve_pb2.py",
    "serve/proxy.py",
    "serve/replica.py",
    "serve/routes.py",
    "serve/rpc_ingress.py",
    "serve/telemetry.py",
    "train/session.py",
    "tune/__init__.py",
    "tune/bohb_search.py",
    "tune/callbacks.py",
    "tune/hyperopt_search.py",
    "tune/optuna_search.py",
    "tune/schedulers.py",
    "tune/search.py",
    "tune/trial.py",
    "tune/tuner.py",
    "util/__init__.py",
    "util/actor_pool.py",
    "util/dask_bridge.py",
    "util/joblib.py",
    "util/metrics.py",
    "util/multiprocessing.py",
    "util/queue.py",
    "util/rpdb.py",
    "util/scheduling_strategies.py",
    "util/state.py",
    "rl/__init__.py",
    "rl/connectors.py",
    "rl/env.py",
    "rl/replay.py",
)

# module -> (reason, top-level names that may differ). A name is a def or
# class, an assigned name, or "import <module>" for an import statement;
# "Class.method" lets one method of a class differ, and the rest of the
# class must equal its source.
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
    "checkpoint/manifest.py": (
        "leaves are torch tensors: a pytree walk of its own with jax's key "
        "strings, a DTensor's local window in place of a jax.Array's "
        "addressable shards, bytes and dtype names without ml_dtypes",
        {"import dataclasses", "import sys", "_np_dtype", "dtype_name",
         "host_bytes", "_as_tensor", "_is_node", "_children",
         "tree_flatten_with_keys", "tree_unflatten", "flatten_with_keys",
         "_is_dtensor", "_is_process_sharded", "dtensor_window",
         "local_shards", "assemble_leaf"},
    ),
    "checkpoint/restore.py": (
        "the port's pytree walk, and leaves placed as the target's or "
        "shardings' DTensors (parallel/sharding.py) in place of "
        "jax.device_put",
        {"import numpy", "_fingerprint_have", "restore", "_place"},
    ),
    "checkpoint/saver.py": (
        "the snapshot copies into pinned host tensors with non-blocking "
        "copies and one stream sync per device",
        {"import numpy", "AsyncCheckpointer"},
    ),
    "collective/__init__.py": (
        "the NCCL backends replace the XLA ones: AUTO reads torch.cuda's "
        "device count, init_collective_group builds NcclMeshGroup / "
        "NcclDistGroup (dist_backend, devices)",
        {"_resolve_backend", "init_collective_group", "_dispatch",
         "_dispatch_async"},
    ),
    "collective/types.py": (
        "Backend names the NCCL data planes (nccl_mesh, nccl)",
        {"Backend"},
    ),
    "collective/codec.py": (
        "the jax half becomes a torch half on tensors of any device; the "
        "residual and error feedback keep a tensor on its device",
        {"is_tensor", "quantization_residual", "ErrorFeedback",
         "quantize_jax", "quantize_blocked_jax", "dequantize_jax",
         "wire_nbytes_jax", "quantize_torch", "quantize_blocked_torch",
         "dequantize_torch", "wire_nbytes_torch"},
    ),
    "collective/algo.py": (
        "the hierarchical allreduce is eager torch over per-rank tensors "
        "(no compiled program cache), with its own slice-device shim",
        {"_HIER_PROGRAMS", "hierarchical_allreduce", "_hier_masked_fn",
         "_hier_masked", "SliceDevice", "fake_slice_devices", "device_of"},
    ),
    "collective/bucketer.py": (
        "leaves may be torch tensors (buckets built on their device), "
        "trees flatten through checkpoint/manifest.py's walk (jax's key "
        "strings, without jax), and the analytic cost reads NVLink",
        {"import sys", "bucket_analytic_cost_s", "LINK_BANDWIDTH",
         "link_bandwidth_per_gpu", "collective_wire_factor", "_leaf", "_dtype_key", "_itemsize", "_numel", "_floating",
         "_concat", "_contiguous", "_zeros", "_zeros_of",
         "import ray_tpu_torch.checkpoint.manifest", "PendingSync",
         "BucketStream", "PendingZeroGather", "PendingZeroSync",
         "GradBucketer"},
    ),
    "collective/backends/cpu_group.py": (
        "payloads may be torch tensors: reduced with torch on the device "
        "they arrive on, results back on the caller's device",
        {"import sys", "_REDUCERS", "_COMBINERS", "_as_payload", "_reducer", "_combiner", "_acc_dtype", "_as",
         "_array_split", "_zeros", "_concat", "_numel", "_on_device",
         "_compress", "_dequantize_wire", "_decompress", "_contrib_array",
         "CpuGroup"},
    ),
    "data/arrow_block.py": (
        "the extension type's registration also collects garbage at exit: "
        "cycles left by reading a tensor column abort the process when "
        "the interpreter's finalization collects them",
        {"import atexit", "import gc", "_register"},
    ),
    "data/block.py": (
        "a torch.Tensor column (any device) becomes host numpy through "
        "detach().cpu().numpy(), bf16 as float32 (numpy has no bf16 "
        "without ml_dtypes): exact in value, but the dtype is not the JAX "
        "package's ml_dtypes.bfloat16; ragged rows (token lists of "
        "several lengths) become an object array, where numpy >= 1.24 "
        "makes the JAX package's np.asarray raise",
        {"_as_array"},
    ),
    "dag/compiled.py": (
        "a collective node reduces torch tensors with torch on the "
        "caller's device, in rank order as the CPU group does; numpy "
        "payloads keep the numpy path",
        {"_dag_actor_loop"},
    ),
    "experimental/collective.py": (
        "create_collective_group passes a nccl group's dist_backend",
        {"_group_init", "create_collective_group"},
    ),
    "serve/controller.py": (
        "a replica's num_gpus is leased as the GPU resource, as "
        "api._normalize_options does, in place of num_tpus as TPU",
        {"ServeController._start_replica"},
    ),
    "runtime/node.py": (
        "an idle node's keepalive comes three times per HEALTH_TIMEOUT_S "
        "(the source's fixed 5 s lets a head with a shorter timeout reap "
        "a live node between two)",
        {"NodeManager._heartbeat_loop"},
    ),
    "runtime/memory.py": (
        "the memory plane samples the CUDA caching allocator, in a process "
        "that already holds a CUDA context only",
        {"import sys", "DEVICE_HBM_GB", "is_resource_exhausted",
         "tag_arrays", "_leaves", "_cuda", "_device_stats",
         "_live_array_bytes", "device_capacity_bytes", "oom_report"},
    ),
    "train/admission.py": (
        "the gang's accelerators are the runtime's GPU resource",
        {"cluster_chips"},
    ),
    "train/zero.py": (
        "the shard-local update is the port's AdamW per leaf (a one-leaf "
        "tree, clipped by the norm the caller passes), not optax",
        {"import torch", "_LEAF", "ZeroOptimizer"},
    ),
    "train/telemetry.py": (
        "MFU reads the GPU's peak and the process group's size; no jax "
        "host-sync watch (finish_step calls train/profile.py's step_hook "
        "as the source does, and leaves out the host-sync attribution)",
        {"PEAK_FLOPS", "DEFAULT_PEAK_FLOPS", "peak_flops_per_chip",
         "host_sync_attribution", "compute_mfu", "finish_step"},
    ),
    "train/profile.py": (
        "the step profiler on torch.profiler: captures are read by "
        "_private/kernel_profile.py (no xplane); the static floors come "
        "from the config's FLOPs and gradient bytes (no HLO to walk), "
        "signed by a hash of the config, batch, sequence and mesh; H100 "
        "bandwidths; MFU counts the process group's GPUs; a failed "
        "capture also stops its profiler",
        {"import glob", "import dataclasses", "HBM_GBPS",
         "DEFAULT_HBM_GBPS", "ICI_GBPS", "DEFAULT_ICI_GBPS",
         "_chip_table_lookup", "analyze_compiled", "_analyze_text",
         "_world_size", "_config_sig", "analyze_train_step",
         "attribution_report", "_read_capture", "step_hook",
         "_step_hook_armed", "_finish_capture", "profile_train_step"},
    ),
    "autoscaler/gcp.py": (
        "the GPU provider in place of the TPU one: GkeGpuNodeProvider "
        "creates a GCE instance per node (compute/v1 instances insert, "
        "polled on the zone's operations, listed by a label filter that "
        "leaves out terminal states) where GkeTpuNodeProvider creates a "
        "Cloud TPU queued resource; its node_pool mode is the source's",
        {"import urllib.parse", "_TPU_API", "_COMPUTE_API",
         "_TERMINAL_STATES", "GkeTpuNodeProvider", "GkeGpuNodeProvider"},
    ),
    "autoscaler/providers.py": (
        "re-exports the GPU provider where the source re-exports the TPU "
        "one",
        {"import ray_tpu_torch.autoscaler.gcp"},
    ),
    "autoscaler/__init__.py": (
        "exports GkeGpuNodeProvider in place of GkeTpuNodeProvider",
        {"import ray_tpu_torch.autoscaler.providers", "__all__"},
    ),
    "rl/module.py": (
        "functional torch modules: init takes a torch.Generator, forward "
        "works on tensors; tree helpers, params_to_torch and "
        "params_from_jax carry weights across",
        {"import dataclasses", "import typing", "import jax",
         "import jax.numpy", "import torch", "tree_map", "tree_leaves",
         "tree_unflatten", "RLModule.init", "RLModule.forward",
         "_dense_init", "_as_input", "MLPModule.init", "MLPModule.forward",
         "params_to_numpy", "params_to_torch", "params_from_jax"},
    ),
    "rl/learner.py": (
        "the loss under torch.autograd, then the optimizer, on one "
        "device; a dp mesh is one process per rank, each taking its "
        "rows along the leaf's row axis, the gradients mean-reduced over "
        "the dp group",
        {"import jax", "import jax.numpy", "import optax",
         "import jax.sharding", "import numpy", "import torch",
         "import ray_tpu_torch.rl.module", "LossFn", "_dp_size",
         "_to_device", "Learner"},
    ),
    "rl/algorithm.py": (
        "the config names the learner's device; "
        "compute_actions runs there; make_adam is optax's clipped Adam "
        "by hand",
        {"import optax", "import torch", "import ray_tpu_torch.rl.module",
         "AlgorithmConfig", "Algorithm.compute_actions", "ClippedAdam",
         "make_adam"},
    ),
    "rl/env_runner.py": (
        "the rollout forward is torch on the CPU under no_grad",
        {"import torch", "import ray_tpu_torch.rl.module",
         "EnvRunner.__init__", "EnvRunner.set_weights", "_cpu_forward"},
    ),
    "rl/ppo.py": (
        "the loss on tensors; the learner on the config's device",
        {"import jax", "import jax.numpy", "import torch", "ppo_loss",
         "PPO._make_learner"},
    ),
    "rl/impala.py": (
        "the loss on tensors; v-trace a reversed loop over time on the "
        "learner's device in place of lax.scan; under a dp learner the "
        "rows are the env columns and the advantage statistics are the "
        "whole batch's",
        {"import jax", "import jax.numpy", "import torch", "vtrace_targets",
         "ROLLOUT_AXES", "_normalized", "vtrace_loss",
         "IMPALA._make_learner"},
    ),
    "rl/appo.py": (
        "the loss on tensors; the target network a clone refreshed in "
        "place under no_grad",
        {"import jax", "import jax.numpy", "import torch",
         "import ray_tpu_torch.rl.impala", "import ray_tpu_torch.rl.module",
         "appo_loss", "APPO.__init__", "APPO._make_learner",
         "APPO._after_update"},
    ),
    "rl/dqn.py": (
        "the loss on tensors; the learner on the config's device",
        {"import jax", "import jax.numpy", "import torch", "dqn_loss",
         "DQN._make_learner"},
    ),
    "rl/sac.py": (
        "the module and loss on tensors; polyak targets updated in place "
        "under no_grad",
        {"import jax", "import jax.numpy", "import torch",
         "import ray_tpu_torch.rl.module", "SACModule", "sac_loss",
         "SAC.__init__", "SAC._make_learner"},
    ),
    "rl/bc.py": (
        "the loss on tensors; the learner on the config's device",
        {"import jax", "import jax.numpy", "import torch", "bc_loss",
         "BC._make_learner"},
    ),
    "rl/multi_agent.py": (
        "the rollout forward is torch on the CPU under no_grad",
        {"import ray_tpu_torch.rl.env_runner",
         "import ray_tpu_torch.rl.module", "MultiAgentEnvRunner.__init__",
         "MultiAgentEnvRunner.set_weights"},
    ),
    "rl/offline.py": (
        "the evaluation's forward is torch on the CPU; OfflineBC's "
        "learner takes the config's device",
        {"evaluate_policy", "OfflineBC.__init__"},
    ),
    "train/trainer.py": (
        "TorchTrainer: GPU scaling, a NCCL collective group and a default "
        "torch.distributed group per worker, no jax platform or watch",
        {"import os", "import tempfile", "ScalingConfig", "RunConfig",
         "_init_default_process_group", "TrainWorker", "JaxTrainer",
         "TorchTrainer"},
    ),
    "tune/sweep.py": (
        "a trial gang leases GPUs: SweepConfig.gpus_per_worker in place "
        "of chips_per_worker, the trainer a TorchTrainer with "
        "ScalingConfig(use_gpu, gpus_per_worker), and admission counts "
        "the GPU resource where the source counts TPU",
        {"SweepConfig", "Sweep._make_trainer", "Sweep._admit_and_launch"},
    ),
    "util/tracing.py": (
        "jax_profile becomes torch_profile (torch.profiler, Chrome trace); "
        "its capture handle keeps the stopped profiler for reading",
        {"ProfileCapture", "jax_profile", "torch_profile"},
    ),
    "daemon.py": (
        "the default session directory is the port's own, so that one "
        "package's stop never signals the other's daemons",
        {"DEFAULT_SESSION_DIR"},
    ),
    "job.py": (
        "a job's log goes under the temporary directory's "
        "ray_tpu_torch_jobs, not /tmp/ray_tpu_jobs",
        {"import tempfile", "JobSubmissionClient.submit_job"},
    ),
    "_private/lint/core.py": (
        "the four jit rules (TPU602-605) and their passes are not ported: "
        "the port traces and compiles nothing",
        {"RULES", "_passes"},
    ),
    "_private/lint/cli.py": (
        "--knob-docs renders the table under a ### heading, for the "
        "README's section on the port",
        {"knob_docs_markdown"},
    ),
    "_private/lint/pass_host_sync.py": (
        "TPU601's explicit syncs are torch's: synchronize() on "
        "torch.cuda, a stream or an event, and .cpu(), .tolist(), "
        ".item() on a tensor, in place of block_until_ready/device_get",
        {"STRONG_SYNCS", "STRONG_METHODS", "_sync_kind", "run",
         "finalize", "_Visitor"},
    ),
    "_private/lint/pass_knobs.py": (
        "README drift is read in the README's section on the port only, "
        "where the README has one (the rest documents the JAX package's "
        "knobs)",
        {"PORT_SECTION", "_readme_region", "_doc_drift"},
    ),
    "_private/lint/pass_metrics.py": (
        "the profiler span the TPU402 check knows is torch_profile, in "
        "place of jax_profile",
        {"_SPAN_CMS", "_GATE_TOKENS"},
    ),
    "scripts.py": (
        "start --tls "
        "refuses plainly without the cryptography package when it must "
        "generate the certificate; the timeline's default path is under "
        "the temporary directory",
        {"cmd_start", "_tls_material_given", "main"},
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
MISSING: set = set()


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


def _statements(text: str, names=frozenset()) -> list[tuple[str, str]]:
    """(name, dump) of each top-level statement. A class with a method
    listed in ``names`` as "Class.method" is dumped without it, and the
    method comes under its own name."""
    tree = _strip_docstrings(ast.parse(text))
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            split = [item for item in node.body
                     if f"{node.name}.{getattr(item, 'name', '')}" in names]
            node.body = [item for item in node.body if item not in split]
            out += [(f"{node.name}.{item.name}", ast.dump(item))
                    for item in split]
        out.append((_key(node), ast.dump(node)))
    return out


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
    want, got = _statements(_source(rel), names), _statements(
        (PORT / rel).read_text(), names)
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
    # The shared-memory store's C++ source is copied byte for byte, and
    # serve's protocol with the package renamed in its comments.
    assert ((PORT / "native/shmstore/shmstore.cpp").read_bytes()
            == (REPO / "native/shmstore/shmstore.cpp").read_bytes())
    assert ((PORT / "serve/protos/serve.proto").read_text()
            == _source("serve/protos/serve.proto"))


def test_comments_state_no_tpu_figure():
    """Docstrings and comments of the port's ported modules may say GPU
    where the source says TPU, but state no TPU time, rate or size."""
    figure = re.compile(r"\bv[456][a-z]*\b.*\d+(\.\d+)?\s*(GB|GiB|ms|s)\b")
    for rel in PORTED:
        text = (PORT / rel).read_text()
        for line in text.splitlines():
            assert not figure.search(line), f"{rel}: {line.strip()}"
