"""The tensor-parallel serving engine of the port (``LLMEngine(mesh=)``)
against the reference's engine built with a {"tp": 2} mesh and against
the port's single-device engine: token streams identical, paged (plain
and speculative) and dense, and each rank's paged pool holding its half
of the KV heads.

The port side runs in 2 spawned ranks of a gloo process group
(tests/torch_spawn_util.py), once per module; this module's top level
imports torch, numpy and ray_tpu_torch only.
"""

import numpy as np
import pytest

from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.models.llama import PRESETS, params_from_jax
from ray_tpu_torch.parallel.mesh import make_mesh

CFG = PRESETS["tiny"]
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [9, 8, 7], [5] * 20]
CASES = {
    "paged": dict(kv="paged"),
    "speculative": dict(kv="paged", speculate=3),
    "dense": dict(kv="dense"),
}
MAX_TOKENS = 12


def _engine(params, mesh, kw):
    return LLMEngine(CFG, max_batch=2, max_seq=128, params=params,
                     device="cpu", mesh=mesh, **kw)


def _worker(rank, world, params):
    mesh = make_mesh({"tp": world}, device_type="cpu")
    greedy = SamplingParams(max_tokens=MAX_TOKENS)
    out = {}
    for name, kw in CASES.items():
        eng = _engine(params, mesh, kw)
        out[name] = eng.generate(PROMPTS, greedy)
        out[name + "_solo"] = _engine(params, None, kw).generate(PROMPTS,
                                                                 greedy)
        out[name + "_kv_heads"] = eng.cache["k"].shape[
            2 if kw["kv"] == "paged" else 3]
    out["sampled"] = _engine(params, mesh, CASES["paged"]).generate(
        PROMPTS, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.8))
    return out


@pytest.fixture(scope="module")
def ref():
    import jax

    from ray_tpu.llm import LLMEngine as RefEngine
    from ray_tpu.llm import SamplingParams as RefSampling
    from ray_tpu.models import PRESETS as REF_PRESETS
    from ray_tpu.models import init_params
    from ray_tpu.parallel import make_mesh as ref_make_mesh

    rcfg = REF_PRESETS["tiny"]
    params = init_params(jax.random.key(0), rcfg)
    mesh = ref_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    streams = {}
    for name, kw in CASES.items():
        eng = RefEngine(rcfg, max_batch=2, max_seq=128, params=params,
                        mesh=mesh, **kw)
        streams[name] = eng.generate(PROMPTS,
                                     RefSampling(max_tokens=MAX_TOKENS))
    return {"params": jax.tree.map(np.asarray, params), "streams": streams}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    params = params_from_jax(ref["params"], CFG, device="cpu")
    return run_ranks(_worker, 2, tmp_path_factory.mktemp("rdzv"), params)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_streams_match_reference_tp_engine(ref, ranks, name):
    for out in ranks:
        assert out[name] == ref["streams"][name]


@pytest.mark.parametrize("name", list(CASES))
def test_tp_streams_match_single_device_engine(ranks, name):
    for out in ranks:
        assert out[name] == out[name + "_solo"]


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_half_the_kv_heads(ranks, name):
    assert all(out[name + "_kv_heads"] == CFG.n_kv_heads // 2
               for out in ranks)


def test_ranks_sample_the_same_tokens(ranks):
    """Temperature sampling: the same generator seed and the gathered
    logits give every rank the same stream."""
    assert ranks[0]["sampled"] == ranks[1]["sampled"]
    assert all(len(s) == MAX_TOKENS for s in ranks[0]["sampled"])
