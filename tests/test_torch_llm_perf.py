"""The port's serving benchmarks (ray_tpu_torch/_private/llm_perf.py) and
the engine's RAY_TPU_PAGED_ATTN switch against the JAX package, on the
CPU: the switch's two routes give the JAX engine's greedy streams under
the same setting (the JAX package's tests/test_paged_attention_kernel.py
checks the same on its own engine); an op row's three attention bodies
agree at a narrow size; the decode@64 and prefill-stall rows run at
``tiny`` with the JAX package's keys; ``main`` refuses a box without a
GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import paged_kv as jpk
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.models import llama as jllama
from ray_tpu_torch._private import llm_perf
from ray_tpu_torch.llm import paged_kv as tpk
from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.models.llama import PRESETS, LlamaConfig, params_from_jax
from ray_tpu_torch.ops.paged_attention import paged_attention

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12]]

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _port_streams(tparams, monkeypatch):
    """Greedy streams of the port's paged engine under the current
    RAY_TPU_PAGED_ATTN, with the wrapper's calls counted."""
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return paged_attention(*args)

    monkeypatch.setattr(tpk, "paged_attention", counting)
    eng = LLMEngine(CFG, max_batch=2, max_seq=64, params=tparams,
                    kv="paged", page_size=16, device="cpu")
    outs = eng.generate(PROMPTS, SamplingParams(max_tokens=6))
    return eng, outs, len(calls)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_engine_switch_matches_the_jax_engine(flag, jparams, tparams,
                                              monkeypatch):
    """RAY_TPU_PAGED_ATTN=0 decodes through the gather path (the wrapper
    is never called), =1 through the wrapper (once per layer per decode
    step); either way the streams are the JAX engine's under the same
    setting (its =1 runs the Pallas kernel interpreted)."""
    monkeypatch.setenv("RAY_TPU_PAGED_ATTN", flag)
    eng, outs, calls = _port_streams(tparams, monkeypatch)
    assert eng.paged_attn_kernel == (flag == "1")
    steps = eng.stats()["decode_steps"]
    assert steps > 0
    assert calls == (CFG.n_layers * steps if flag == "1" else 0)
    jeng = JaxEngine(JCFG, max_batch=2, max_seq=64, params=jparams,
                     kv="paged", page_size=16)
    assert jeng.paged_attn_kernel == (flag == "1")
    assert outs == jeng.generate(PROMPTS, JaxSampling(max_tokens=6))


def test_engine_switch_routes_agree_and_default(tparams, monkeypatch):
    """The two routes' greedy streams are equal, and with the switch
    unset a CPU engine takes the gather path."""
    monkeypatch.delenv("RAY_TPU_PAGED_ATTN", raising=False)
    eng, unset, calls = _port_streams(tparams, monkeypatch)
    assert not eng.paged_attn_kernel and calls == 0
    monkeypatch.setenv("RAY_TPU_PAGED_ATTN", "1")
    eng, kernel, calls = _port_streams(tparams, monkeypatch)
    assert eng.paged_attn_kernel and calls > 0
    assert kernel == unset


def _op_inputs(heads, b=8, max_pages=4, long_len=200, short_len=20,
               long_every=4):
    """An op row's inputs at a narrow size, fp32 from a numpy seed: the
    tables and lengths built as llm_perf builds them (-1 past each slot's
    pages)."""
    rng = np.random.default_rng(3)
    h, hkv = heads
    dh, page = 128, 64
    npages = b * max_pages
    q = rng.normal(size=(b, 1, h, dh)).astype(np.float32)
    kp = rng.normal(size=(npages, hkv, page, dh)).astype(np.float32)
    vp = rng.normal(size=(npages, hkv, page, dh)).astype(np.float32)
    lens = np.where(np.arange(b) % long_every == 0, long_len, short_len)
    tables = np.full((b, max_pages), -1, np.int32)
    nxt = 1
    for bi in range(b):
        need = (lens[bi] + 1 + page - 1) // page
        tables[bi, :need] = np.arange(nxt, nxt + need) % npages
        nxt += need
    return q, kp, vp, tables, lens.astype(np.int32)


@pytest.mark.parametrize("heads", [(8, 4), (32, 8)])
def test_op_row_bodies_agree(heads):
    """The wrapper's CPU route (its plain version), the port's gather body
    and the JAX package's gather body, under the op row's window mask,
    agree within 2e-5 at B=8, head_dim 128, fp32."""
    q, kp, vp, tables, lens = _op_inputs(heads)
    h, hkv = heads
    window = tables.shape[1] * kp.shape[2]
    mask = np.arange(window)[None, None, :] > lens[:, None, None]
    index = np.maximum(tables, 0)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    wrapper = paged_attention(*t).numpy()
    tcfg = LlamaConfig(d_model=h * 128, n_heads=h, n_kv_heads=hkv,
                       dtype=torch.float32)
    gather = tpk._gather_page_attention(
        t[0], t[1], t[2], torch.from_numpy(index).long(),
        torch.from_numpy(mask), tcfg).numpy()
    jcfg = jllama.LlamaConfig(d_model=h * 128, n_heads=h, n_kv_heads=hkv,
                              dtype=jnp.float32)
    ref = np.asarray(jpk._gather_page_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(index), jnp.asarray(mask), jcfg))
    np.testing.assert_allclose(gather, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(wrapper, ref, atol=2e-5, rtol=2e-5)


def test_attention_op_row_runs_on_the_cpu():
    """bench_attention_op_batch64 on the CPU at a 2-page table: the JAX
    package's keys, both routes timed."""
    row = llm_perf.bench_attention_op_batch64(
        steps=1, max_pages=2, long_len=100, short_len=10, device="cpu")
    assert set(row) == {"kernel_us", "gather_us", "speedup"}
    assert row["kernel_us"] > 0 and row["gather_us"] > 0
    assert row["speedup"] == pytest.approx(row["gather_us"]
                                           / row["kernel_us"])


def _streams(eng, requests):
    by_id = {r.request_id: list(r.out_tokens) for r in eng._active.values()}
    return [by_id[rid] for rid, _ in requests]


def test_decode_batch64_rows_at_tiny(tparams):
    """decode@64 at tiny: the JAX package's keys; the kernel engine takes
    the wrapper, the gather engine the gather path, over the same 64
    prompts, and their greedy streams agree."""
    seen = {}

    def inspect(label, eng, requests):
        assert len(requests) == 64
        seen[label] = (eng.paged_attn_kernel, eng.stats()["decode_steps"],
                       _streams(eng, requests))

    row = llm_perf.bench_decode_batch64(tparams, steps=2, model="tiny",
                                        device="cpu", inspect=inspect)
    assert set(row) == {"kernel", "gather", "speedup"}
    for label in ("kernel", "gather"):
        assert set(row[label]) == {"steps_per_s", "tok_per_s", "ms_per_step"}
        assert row[label]["tok_per_s"] == pytest.approx(
            64 * row[label]["steps_per_s"])
    assert row["speedup"] == pytest.approx(
        row["kernel"]["tok_per_s"] / row["gather"]["tok_per_s"])
    assert seen["kernel"][0] and not seen["gather"][0]
    # admission (one step, every request admitted), the warm step, 2 timed
    assert seen["kernel"][1] == seen["gather"][1] == 4
    assert all(len(s) == 5 for s in seen["kernel"][2])
    assert seen["kernel"][2] == seen["gather"][2]


def test_prefill_stall_rows_at_tiny(tparams):
    """The prefill stall at tiny: the JAX package's keys; the chunked
    engine prefills both 7935/7936-token prompts in 1024-token chunks (8
    each), the monolithic one in none, and the 8 decode requests' greedy
    streams are equal across the two, as is the long prompt's stream as
    far as the chunked engine's goes."""
    seen = {}

    def inspect(label, eng, requests):
        assert len(requests) == 9 and eng.paged_attn_kernel
        assert len(requests[-1][1]) == 7936
        seen[label] = (eng.stats()["prefill_chunks"], _streams(eng, requests))

    row = llm_perf.bench_prefill_stall(tparams, model="tiny", device="cpu",
                                       inspect=inspect)
    assert set(row) == {"chunked", "monolithic", "stall_ratio_p99"}
    for label in ("chunked", "monolithic"):
        assert set(row[label]) == {"p50_ms", "p99_ms", "max_ms"}
        assert 0 < row[label]["p50_ms"] <= row[label]["p99_ms"] \
            <= row[label]["max_ms"]
    assert row["stall_ratio_p99"] == pytest.approx(
        row["monolithic"]["p99_ms"] / row["chunked"]["p99_ms"])
    assert seen["chunked"][0] == 16
    assert seen["monolithic"][0] == 0
    chunked, mono = seen["chunked"][1], seen["monolithic"][1]
    # the prefill's token, then one decode token in each of the admission
    # step, 4 + 12 warm steps and 16 timed ones
    assert all(len(s) == 34 for s in chunked[:8])
    assert chunked[:8] == mono[:8]
    long_chunked, long_mono = chunked[8], mono[8]
    assert 0 < len(long_chunked) < len(long_mono)
    assert long_chunked == long_mono[:len(long_chunked)]


def test_main_refuses_a_box_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        llm_perf.main([])
