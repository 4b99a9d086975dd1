"""The port's model and dense-cache programs against the JAX reference on
the tiny preset, fp32 on the CPU: parameters come from
ray_tpu.models.llama.init_params via params_from_jax, tokens from numpy.
Logits agree to 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import kv_cache as jkv
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import kv_cache as tkv
from ray_tpu_torch.models.llama import (
    PRESETS,
    forward,
    init_params,
    params_from_jax,
)

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
TOL = dict(atol=1e-4, rtol=1e-4)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(b, s)
    ).astype(np.int32)


def test_config_and_presets_match_reference():
    for name in ("tiny", "mini", "bench", "llama3_8b"):
        j, t = jllama.PRESETS[name], PRESETS[name]
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq", "rope_theta", "remat",
                  "attn_impl", "embed_impl"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.head_dim == j.head_dim
        assert t.num_params() == j.num_params()
        for seq in (1, 2048):
            assert t.flops_per_token(seq) == j.flops_per_token(seq)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_init_params_layout_and_distribution():
    p = init_params(CFG, 3, device="cpu")
    j = jllama.init_params(jax.random.key(0), JCFG)
    assert p.keys() == j.keys() and p["blocks"].keys() == j["blocks"].keys()
    for name, leaf in p["blocks"].items():
        assert tuple(leaf.shape) == j["blocks"][name].shape, name
        assert leaf.dtype == torch.float32
    for name in ("attn_norm", "mlp_norm"):
        assert not p["blocks"][name].any()
    wq = p["blocks"]["wq"]
    bound = 2.0 * CFG.d_model**-0.5
    assert float(wq.abs().max()) <= bound + 1e-7
    # Truncated N(0, 1) on [-2, 2] has std ~0.880.
    std = float(wq.std()) * CFG.d_model**0.5
    assert 0.85 < std < 0.91
    again = init_params(CFG, 3, device="cpu")
    other = init_params(CFG, 4, device="cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])
    assert not torch.equal(other["lm_head"], p["lm_head"])


def test_params_from_jax_keeps_norms_fp32(jparams):
    cfg16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    p = params_from_jax(jax.tree.map(np.asarray, jparams), cfg16, "cpu")
    assert p["tok_emb"].dtype == torch.bfloat16
    assert p["lm_head"].dtype == torch.bfloat16
    assert p["blocks"]["wq"].dtype == torch.bfloat16
    for name in ("attn_norm", "mlp_norm"):
        assert p["blocks"][name].dtype == torch.float32
    assert p["final_norm"].dtype == torch.float32


def test_forward_matches_reference(jparams, tparams):
    tokens = _tokens(0, 2, 24)
    want = jllama.forward(jparams, jnp.asarray(tokens), JCFG)
    got = forward(tparams, torch.from_numpy(tokens), CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq,use_flash", [(32, False), (512, True)])
def test_forward_prefill_matches_reference(jparams, tparams, seq,
                                           use_flash):
    """seq 512 with use_flash takes the flash path on both sides (the
    reference's kernel in interpret mode, the port's plain version)."""
    tokens = _tokens(1, 1, seq)
    j_logits, j_cache = jkv.forward_prefill(
        jparams, jnp.asarray(tokens), jkv.init_kv_cache(JCFG, 2, 1024),
        jnp.int32(1), JCFG, use_flash=use_flash,
    )
    t_logits, t_cache = tkv.forward_prefill(
        tparams, torch.from_numpy(tokens),
        tkv.init_kv_cache(CFG, 2, 1024, device="cpu"), 1, CFG,
        use_flash=use_flash,
    )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL
        )


def test_forward_decode_matches_reference(jparams, tparams):
    """Prefill two slots, then three decode steps at their own positions;
    logits and cache agree after every step."""
    j_cache = jkv.init_kv_cache(JCFG, 2, 64)
    t_cache = tkv.init_kv_cache(CFG, 2, 64, device="cpu")
    lens = [5, 9]
    for slot, n in enumerate(lens):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = _tokens(2 + slot, 1, n)
        _, j_cache = jkv.forward_prefill(
            jparams, jnp.asarray(toks), j_cache, jnp.int32(slot), JCFG
        )
        tkv.forward_prefill(tparams, torch.from_numpy(toks), t_cache, slot,
                            CFG)
    positions = np.asarray(lens, np.int32)
    for step in range(3):
        toks = _tokens(10 + step, 2, 1)
        j_logits, j_cache = jkv.forward_decode(
            jparams, jnp.asarray(toks), j_cache, jnp.asarray(positions),
            JCFG,
        )
        t_logits, t_cache = tkv.forward_decode(
            tparams, torch.from_numpy(toks), t_cache,
            torch.from_numpy(positions), CFG,
        )
        np.testing.assert_allclose(
            t_logits.numpy(), np.asarray(j_logits), **TOL
        )
        positions = positions + 1
    np.testing.assert_allclose(
        t_cache["k"].numpy(), np.asarray(j_cache["k"]), **TOL
    )
