"""Query heads that do not split over tp: mini's head layout (12 query and
4 KV heads) at tp = 8, where a rank's share of the heads' columns ends
inside a head.

The JAX package serves and trains such a mesh (GSPMD splits the fused
``n_heads * head_dim`` columns, and the engine keeps the whole KV pool on
every rank since ``n_kv_heads % tp != 0``). The port attends every head
on every rank and keeps its share of the flattened columns for its rows
of ``wo``: the same token streams (paged and dense) and the same two
training steps as the reference on the 8-device CPU mesh. mini's widths
are narrowed (head_dim 16) to keep 8 ranks small; its head counts are
kept.

The port side runs in 8 spawned ranks of a gloo process group
(tests/torch_spawn_util.py); this module's top level imports torch,
numpy and ray_tpu_torch only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.models.llama import PRESETS, params_from_jax
from ray_tpu_torch.parallel.mesh import make_mesh
from test_torch_parallel_train import _check_train, _opt, _train, STEPS

NARROW = dict(d_model=192, d_ff=256, vocab_size=256, n_layers=2,
              max_seq=128)
CFG = dataclasses.replace(PRESETS["mini"], dtype=torch.float32, **NARROW)
TP = {"tp": 8}
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [9, 8, 7], [5] * 20]
MAX_TOKENS = 8
KV = ("paged", "dense")


def _worker(rank, world, params, tokens):
    mesh = make_mesh(TP, device_type="cpu")
    greedy = SamplingParams(max_tokens=MAX_TOKENS)
    out = {}
    for kv in KV:
        eng = LLMEngine(CFG, max_batch=2, max_seq=64, params=params,
                        device="cpu", mesh=mesh, kv=kv)
        out[kv] = eng.generate(PROMPTS, greedy)
        out[kv + "_kv_heads"] = eng.cache["k"].shape[
            2 if kv == "paged" else 3]
    out["train"] = _train(CFG, params, TP, tokens)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm import LLMEngine as RefEngine
    from ray_tpu.llm import SamplingParams as RefSampling
    from ray_tpu.models import PRESETS as REF_PRESETS
    from ray_tpu.models import init_params
    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.parallel.sharding import tree_shardings
    from ray_tpu.train import step as ref_step

    rcfg = dataclasses.replace(REF_PRESETS["mini"], dtype=jnp.float32,
                               **NARROW)
    assert (rcfg.n_heads, rcfg.n_kv_heads) == (12, 4)
    params = init_params(jax.random.key(0), rcfg)
    mesh = ref_make_mesh(TP)
    out = {"params": jax.tree.map(np.asarray, params)}
    for kv in KV:
        eng = RefEngine(rcfg, max_batch=2, max_seq=64, params=params,
                        mesh=mesh, kv=kv)
        out[kv] = eng.generate(PROMPTS, RefSampling(max_tokens=MAX_TOKENS))
    tokens = np.random.default_rng(3).integers(
        0, rcfg.vocab_size, (4, 33)).astype(np.int32)
    opt = ref_step.make_optimizer(**_opt())
    step = ref_step.jit_train_step(rcfg, opt, mesh)
    state = ref_step.init_train_state(jax.random.key(0), rcfg, opt)
    state = jax.device_put(state, tree_shardings(
        mesh, ref_step.state_logical_axes(rcfg, opt)))
    batch = {"tokens": jax.device_put(tokens, tree_shardings(
        mesh, ("batch", None)))}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out["train"] = dict(metrics=metrics, params={
        "/".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(
            state.params)[0]})
    out["tokens"] = tokens
    return out


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    params = params_from_jax(ref["params"], CFG, device="cpu")
    return run_ranks(_worker, 8, tmp_path_factory.mktemp("rdzv"), params,
                     ref["tokens"])[0]


@pytest.mark.parametrize("kv", KV)
def test_uneven_heads_serve_as_the_reference(ref, port, kv):
    """Streams identical to the reference's tp = 8 engine; every rank
    holds all 4 KV heads (they do not split over 8)."""
    assert port[kv] == ref[kv]
    assert port[kv + "_kv_heads"] == CFG.n_kv_heads


def test_uneven_heads_train_as_the_reference(ref, port):
    """Two steps on {"tp": 8}: losses and gradient norms at rtol 1e-4,
    parameters at 2e-4 (tests/test_torch_parallel_train.py's bounds)."""
    _check_train(port["train"], ref["train"])
