"""ray_tpu_torch ops against the JAX reference ops, on the CPU in fp32.

Inputs come from numpy with a fixed seed and go to both packages. Also
holds the package-wide rules: the port imports neither jax nor ray_tpu,
and an entry point left at its default device never runs on the CPU.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rms_norm_matches_reference():
    x, scale = _np(0, 3, 5, 64), _np(1, 64)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_frequencies_match_reference():
    cos_j, sin_j = jrope.rope_frequencies(64, 300, 500000.0)
    cos_t, sin_t = rope_frequencies(64, 300, 500000.0, device="cpu")
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_reference(with_positions):
    x = _np(2, 2, 7, 4, 16)  # [B, S, H, D]
    cos_j, sin_j = jrope.rope_frequencies(16, 64)
    cos_t, sin_t = rope_frequencies(16, 64, device="cpu")
    pos = None
    if with_positions:
        pos = np.random.default_rng(3).integers(0, 64, size=(2, 7))
    want = jrope.apply_rope(
        jnp.asarray(x), cos_j, sin_j,
        positions=None if pos is None else jnp.asarray(pos),
    )
    got = apply_rope(
        torch.from_numpy(x), cos_t, sin_t,
        positions=None if pos is None else torch.from_numpy(pos),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "q_offset,kv_offset", [(0, 0), (16, 0), (0, 8), (8, 24)]
)
def test_causal_attention_matches_reference(q_offset, kv_offset):
    """GQA 8/2 with shifted query and key blocks, including rows that see
    no key at all (kv_offset past the query: those rows are zero)."""
    q, k, v = _np(4, 2, 16, 8, 32), _np(5, 2, 16, 2, 32), _np(6, 2, 16, 2, 32)
    want = jattn.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=q_offset, kv_offset=kv_offset,
    )
    got = causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=q_offset, kv_offset=kv_offset,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_attention_rejects_bad_heads():
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError):
        causal_attention(torch.zeros((1, 8, 4, 16)), k, k)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "paged_attention_chip.py",
              REPO / "sharded_chip.py"]
    assert len(files) > 10
    assert REPO / "ray_tpu_torch" / "models" / "moe.py" in files
    for name in ("mesh.py", "sharding.py", "collectives.py",
                 "ring_attention.py", "ulysses.py", "pipeline.py",
                 "showcase.py"):
        assert REPO / "ray_tpu_torch" / "parallel" / name in files
    for name in ("checkpoint.py", "dataloader.py", "memory.py",
                 "session.py", "trainer.py", "zero.py", "telemetry.py",
                 "admission.py"):
        assert REPO / "ray_tpu_torch" / "train" / name in files
    for name in ("__init__.py", "manifest.py", "store.py", "saver.py",
                 "restore.py", "remote.py", "erasure.py", "fork.py"):
        assert REPO / "ray_tpu_torch" / "checkpoint" / name in files
    assert REPO / "ray_tpu_torch" / "_native" / "dataloader.py" in files
    for name in ("__init__.py", "channel.py", "compiled.py", "context.py",
                 "node.py"):
        assert REPO / "ray_tpu_torch" / "dag" / name in files
    for name in ("__init__.py", "api.py", "batching.py", "config.py",
                 "context.py", "controller.py", "deployment.py",
                 "grpc_ingress.py", "handle.py", "multiplex.py", "proxy.py",
                 "replica.py", "routes.py", "rpc_ingress.py", "telemetry.py",
                 "protos/serve_pb2.py"):
        assert REPO / "ray_tpu_torch" / "serve" / name in files
    for name in ("serve_integration.py", "batch.py"):
        assert REPO / "ray_tpu_torch" / "llm" / name in files
    for name in ("__init__.py", "arrow_block.py", "bigquery.py", "block.py",
                 "dataset.py", "datasource.py", "delta.py", "executor.py",
                 "plan.py"):
        assert REPO / "ray_tpu_torch" / "data" / name in files
    for name in ("__init__.py", "bohb_search.py", "callbacks.py",
                 "hyperopt_search.py", "optuna_search.py", "schedulers.py",
                 "search.py", "sweep.py", "trial.py", "tuner.py"):
        assert REPO / "ray_tpu_torch" / "tune" / name in files
    for name in ("__init__.py", "algorithm.py", "appo.py", "bc.py",
                 "connectors.py", "dqn.py", "env.py", "env_runner.py",
                 "impala.py", "learner.py", "module.py", "multi_agent.py",
                 "offline.py", "ppo.py", "replay.py", "sac.py"):
        assert REPO / "ray_tpu_torch" / "rl" / name in files
    for name in ("train/profile.py", "_private/kernel_profile.py",
                 "models/resnet.py", "_private/tls_utils.py", "daemon.py",
                 "job.py", "dashboard.py", "scripts.py",
                 "autoscaler/__init__.py", "autoscaler/gcp.py",
                 "autoscaler/autoscaler.py", "autoscaler/providers.py",
                 "autoscaler/scheduler.py", "util/actor_pool.py",
                 "util/queue.py", "util/multiprocessing.py",
                 "util/joblib.py", "util/dask_bridge.py",
                 "experimental/tqdm_ray.py", "_private/xlang.py",
                 "cross_language.py", "_native/cpp_client.py",
                 "_private/lint/core.py", "_private/lint/cli.py",
                 "_private/lint/protocol.py",
                 "_private/lint/pass_host_sync.py"):
        assert REPO / "ray_tpu_torch" / name in files, name
    for name in ("api.py", "placement.py", "exceptions.py", "version.py",
                 "_native/shmstore.py", "_private/config.py",
                 "_private/ids.py", "_private/rpc.py",
                 "_private/serialization.py", "_private/sanitize.py",
                 "_private/test_utils.py", "_private/usage.py",
                 "_private/accelerators/__init__.py",
                 "_private/accelerators/accelerator.py",
                 "_private/accelerators/gpu.py", "collective/__init__.py",
                 "collective/types.py", "runtime/agent.py",
                 "runtime/core_worker.py", "runtime/drain.py",
                 "runtime/head.py", "runtime/head_storage.py",
                 "runtime/memory.py", "runtime/node.py",
                 "runtime/object_store.py", "runtime/runtime_env.py",
                 "runtime/transfer.py", "runtime/worker_main.py",
                 "util/metrics.py", "util/rpdb.py", "util/state.py",
                 "util/scheduling_strategies.py", "util/tracing.py",
                 "collective/algo.py", "collective/bucketer.py",
                 "collective/codec.py", "collective/flight_recorder.py",
                 "collective/backends/cpu_group.py",
                 "collective/backends/nccl_group.py",
                 "experimental/collective.py",
                 "experimental/tensor_transport.py"):
        assert REPO / "ray_tpu_torch" / name in files, name
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "ray_tpu", "optax", "flax"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_spawned_test_modules_import_no_jax_at_top_level():
    """The multi-process tests' ranks import their test module: its top
    level must not import JAX (the tests import it inside)."""
    names = ("test_torch_parallel_train.py", "test_torch_parallel_engine.py",
             "test_torch_sequence_parallel.py", "test_torch_pipeline.py",
             "test_torch_showcase.py", "test_torch_multislice.py",
             "test_torch_ckpt_manifest.py", "test_torch_resnet.py",
             "test_torch_rl_dp.py", "test_torch_tp_heads.py",
             "test_torch_showcase_loop.py", "torch_spawn_util.py")
    for name in names:
        tree = ast.parse((REPO / "tests" / name).read_text())
        for node in tree.body:
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "ray_tpu"), (name,
                                                                    mod)


def test_default_device_never_falls_back_to_cpu():
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.llm.kv_cache import init_kv_cache
    from ray_tpu_torch.llm.paged_kv import init_paged_kv
    from ray_tpu_torch.models.llama import PRESETS, init_params

    cfg = PRESETS["tiny"]
    if torch.cuda.is_available():
        assert LLMEngine(cfg, max_batch=1, max_seq=32).device.type == "cuda"
        return
    for make in (
        lambda: LLMEngine(cfg, max_batch=1, max_seq=32),
        lambda: init_params(cfg),
        lambda: init_kv_cache(cfg, 1, 32),
        lambda: init_paged_kv(cfg, 4, 8),
    ):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()
