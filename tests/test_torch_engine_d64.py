"""The port's LLMEngine against the reference's at head_dim 64 (mini's
head size; 3 query heads over 1 KV head, so n_rep = 3 as in mini) on a
2-layer config with d 192, fp32 on the CPU: greedy token streams must be
identical, paged, speculative and dense."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.models.llama import PRESETS, params_from_jax

SHAPE = dict(vocab_size=512, d_model=192, n_layers=2, n_heads=3,
             n_kv_heads=1, d_ff=256, max_seq=256)
CFG = dataclasses.replace(PRESETS["tiny"], **SHAPE)
JCFG = dataclasses.replace(jllama.PRESETS["tiny"], **SHAPE)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)

PATTERN = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
CASES = {
    "paged": (dict(kv="paged", page_size=16, max_batch=2, max_seq=64),
              [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12]], 8),
    "paged_64_token_pages": (dict(kv="paged", page_size=64, max_batch=2,
                                  max_seq=192),
                             [list(range(1, 70)), [4, 5, 6]], 8),
    "speculate": (dict(kv="paged", page_size=16, max_batch=2, max_seq=64,
                       speculate=3), [PATTERN, [9, 9, 9, 9, 9]], 10),
    "dense": (dict(kv="dense", max_batch=2, max_seq=64),
              [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12]], 8),
}


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.key(3), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def test_config_is_head_dim_64():
    assert CFG.head_dim == JCFG.head_dim == 64
    assert CFG.n_heads // CFG.n_kv_heads == 3
    assert CFG.num_params() == JCFG.num_params()
    assert JCFG.dtype == jnp.float32 and CFG.dtype == torch.float32


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_greedy_streams_match_reference(jparams, tparams, case):
    kw, prompts, max_tokens = CASES[case]
    jeng = JaxEngine(JCFG, params=jparams, **kw)
    teng = LLMEngine(CFG, params=tparams, device="cpu", **kw)
    want = jeng.generate(prompts, JaxSampling(max_tokens=max_tokens))
    got = teng.generate(prompts, SamplingParams(max_tokens=max_tokens))
    assert got == want
    st, jst = teng.stats(), jeng.stats()
    for key in ("requests_finished", "tokens_generated",
                "draft_tokens_proposed", "draft_tokens_accepted"):
        assert st[key] == jst[key], key
    if kw["kv"] == "paged":
        assert st["pages_free"] == st["pages_total"]
    if case == "speculate":
        assert st["draft_tokens_accepted"] > 0
