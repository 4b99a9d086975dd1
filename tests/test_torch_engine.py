"""The port's paged programs and LLMEngine against the JAX reference on
the tiny preset, fp32 on the CPU. Paged logits agree to 1e-4; greedy
token streams are identical, case by case: paged, dense, speculative,
chunked prefill, preemption under pool pressure, prefix sharing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import paged_kv as jpk
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.llm.engine import SamplingParams as JaxSampling
from ray_tpu.llm.tokenizer import ByteTokenizer as JaxTokenizer
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import paged_kv as tpk
from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models.llama import PRESETS, params_from_jax

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
TOL = dict(atol=1e-4, rtol=1e-4)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)
P = 16  # page size of the paged-program tests


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


def _pools(num_pages):
    return (
        jpk.init_paged_kv(JCFG, num_pages, P),
        tpk.init_paged_kv(CFG, num_pages, P, device="cpu"),
    )


def _close_pools(tp, jp):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tp[name].numpy(), np.asarray(jp[name]), **TOL
        )


def test_paged_prefill_matches_reference(jparams, tparams):
    jp, tp = _pools(8)
    tokens = _tokens(0, 1, 3 * P)
    pages = np.asarray([5, 2, 7], np.int32)
    j_logits, jp = jpk.paged_prefill(
        jparams, jnp.asarray(tokens), jp, jnp.asarray(pages), cfg=JCFG,
        n_write_pages=3,
    )
    t_logits, tp = tpk.paged_prefill(
        tparams, torch.from_numpy(tokens), tp, torch.from_numpy(pages),
        cfg=CFG, n_write_pages=3,
    )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    _close_pools(tp, jp)


def test_paged_prefill_chunk_matches_reference(jparams, tparams):
    """Two chunks of 2 pages over a 4-page context table."""
    jp, tp = _pools(8)
    tokens = _tokens(1, 1, 4 * P)
    pages = np.asarray([3, 6, 1, 4], np.int32)
    for start in (0, 2 * P):
        chunk = tokens[:, start: start + 2 * P]
        j_logits, jp = jpk.paged_prefill_chunk(
            jparams, jnp.asarray(chunk), jp, jnp.asarray(pages),
            jnp.int32(start), cfg=JCFG, n_write_pages=4, chunk_pages=2,
        )
        t_logits, tp = tpk.paged_prefill_chunk(
            tparams, torch.from_numpy(chunk), tp, torch.from_numpy(pages),
            start, cfg=CFG, n_write_pages=4, chunk_pages=2,
            write_pages=torch.from_numpy(pages),
        )
        np.testing.assert_allclose(
            t_logits.numpy(), np.asarray(j_logits), **TOL
        )
    _close_pools(tp, jp)


@pytest.mark.parametrize("kq", [1, 3])
def test_paged_verify_matches_reference(jparams, tparams, kq):
    """Prefill three slots (one left inactive), then verify K tokens per
    slot across a page boundary; logits of position 0, greedy samples and
    acceptance agree, and the pools agree after the scatter."""
    jp, tp = _pools(12)
    tables = np.full((3, 4), -1, np.int32)
    tables[0, :2] = [1, 2]
    tables[2, :3] = [5, 6, 7]
    lens = [P + 3, 0, 2 * P - 1]
    for slot in (0, 2):
        n_pages = int((tables[slot] >= 0).sum())
        toks = np.zeros((1, n_pages * P), np.int32)
        toks[0, : lens[slot]] = _tokens(3 + slot, 1, lens[slot])
        pages = tables[slot, :n_pages]
        _, jp = jpk.paged_prefill(
            jparams, jnp.asarray(toks), jp, jnp.asarray(pages), cfg=JCFG,
            n_write_pages=n_pages,
        )
        tpk.paged_prefill(
            tparams, torch.from_numpy(toks), tp, torch.from_numpy(pages),
            cfg=CFG, n_write_pages=n_pages,
        )
    tokens = _tokens(9, 3, kq)
    positions = np.asarray(lens, np.int32)
    temps = np.zeros((3,), np.float32)
    j_out = jpk.paged_verify(
        jparams, jnp.asarray(tokens), jp, jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(temps), jax.random.key(0),
        cfg=JCFG, stochastic=False,
    )
    t_out = tpk.paged_verify(
        tparams, torch.from_numpy(tokens), tp, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(temps),
        torch.Generator().manual_seed(0), cfg=CFG, stochastic=False,
    )
    j_sampled, j_accept, j_rej, j_logits, jp = j_out
    t_sampled, t_accept, t_rej, t_logits, tp = t_out
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    active = [0, 2]
    for t, j in ((t_sampled, j_sampled), (t_accept, j_accept),
                 (t_rej, j_rej)):
        np.testing.assert_array_equal(t.numpy()[active],
                                      np.asarray(j)[active])
    # Page 0 is the dump page: the inactive slot's writes land there.
    np.testing.assert_allclose(
        tp["k"][:, 1:].numpy(), np.asarray(jp["k"])[:, 1:], **TOL
    )


def test_paged_decode_kernel_flag_takes_plain_path_on_cpu(tparams):
    """use_kernel=True on CPU tensors is the plain version: same logits
    as the gather path."""
    tables = np.asarray([[1, 2, -1]], np.int32)
    outs = []
    for use_kernel in (False, True):
        _, tp = _pools(4)
        toks = np.zeros((1, 2 * P), np.int32)
        toks[0, :20] = _tokens(4, 1, 20)
        tpk.paged_prefill(tparams, torch.from_numpy(toks), tp,
                          torch.tensor([1, 2]), cfg=CFG, n_write_pages=2)
        _, logits, _ = tpk.paged_decode(
            tparams, torch.from_numpy(_tokens(5, 1, 1)), tp,
            torch.from_numpy(tables), torch.tensor([20], dtype=torch.int32),
            torch.zeros(1), torch.Generator().manual_seed(0), cfg=CFG,
            use_kernel=use_kernel,
        )
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_sample_on_device_greedy_and_in_vocab():
    logits = torch.from_numpy(
        np.random.default_rng(8).normal(size=(4, CFG.vocab_size))
    ).float()
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7])
    gen = torch.Generator().manual_seed(0)
    out = tpk.sample_on_device(logits, temps, gen)
    want = jpk.sample_on_device(
        jnp.asarray(logits.numpy()), jnp.asarray(temps.numpy()),
        jax.random.key(0),
    )
    greedy = [0, 2]
    np.testing.assert_array_equal(out.numpy()[greedy],
                                  np.asarray(want)[greedy])
    assert ((out >= 0) & (out < CFG.vocab_size)).all()


def test_allocator_and_prefix_hashes_match_reference():
    toks = list(range(1, 40))
    assert tpk.prefix_hashes(toks, 8) == jpk.prefix_hashes(toks, 8)
    ja, ta = jpk.PageAllocator(4, 8), tpk.PageAllocator(4, 8)
    for a in (ja, ta):
        p1 = a.alloc()
        a.share(p1)
        a.register_prefix(77, p1)
        a.release(p1)
    assert ta.free_pages == ja.free_pages == 3
    assert ta.lookup_prefix(77) == ja.lookup_prefix(77)
    ta.release(ta.lookup_prefix(77))
    assert ta.lookup_prefix(77) is None and ta.free_pages == 4


def test_ngram_draft_matches_reference():
    rng = np.random.default_rng(6)
    for _ in range(20):
        ctx = rng.integers(0, 5, size=int(rng.integers(1, 30))).tolist()
        for k in (0, 1, 3):
            assert tpk.propose_ngram_draft(ctx, k) == \
                jpk.propose_ngram_draft(ctx, k)


def test_tokenizer_matches_reference():
    text = "héllo, wörld"
    assert ByteTokenizer().encode(text) == JaxTokenizer().encode(text)
    ids = ByteTokenizer().encode(text)
    assert ByteTokenizer().decode(ids) == JaxTokenizer().decode(ids) == text


# ------------------------------------------------ engine token streams
HEAD = [(3 * i) % CFG.vocab_size for i in range(32)]
ENGINE_CASES = {
    "paged": (dict(kv="paged", page_size=16, max_batch=2, max_seq=64),
              [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12]], 6),
    "dense": (dict(kv="dense", max_batch=2, max_seq=64),
              [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12]], 6),
    "speculate": (dict(kv="paged", page_size=16, max_batch=2, max_seq=64,
                       speculate=3),
                  [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [9, 9, 9, 9, 9]], 8),
    "prefill_chunk": (dict(kv="paged", page_size=16, max_batch=3,
                           max_seq=128, prefill_chunk=32),
                      [list(range(1, 80)), [4, 5, 6], list(range(2, 40))],
                      5),
    "preemption": (dict(kv="paged", page_size=8, num_pages=4, max_batch=2,
                        max_seq=64),
                   [[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14]], 20),
    "prefix_sharing": (dict(kv="paged", page_size=16, max_batch=3,
                            max_seq=64),
                       [HEAD + [5, 6], HEAD + [9], HEAD[:16] + [1]], 5),
    # page sizes the kernel's stage rule treats apart: 16 pages of 4 per
    # stage, and a page over two stages (the reference engine's prefill
    # buckets take page sizes that divide them only)
    "page4": (dict(kv="paged", page_size=4, max_batch=2, max_seq=64),
              [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12]], 6),
    "page128": (dict(kv="paged", page_size=128, max_batch=2, max_seq=256),
                [list(range(1, 140)), [7, 8]], 6),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_streams_match_reference(jparams, tparams, case):
    kw, prompts, max_tokens = ENGINE_CASES[case]
    jeng = JaxEngine(JCFG, params=jparams, **kw)
    teng = LLMEngine(CFG, params=tparams, device="cpu", **kw)
    want = jeng.generate(prompts, JaxSampling(max_tokens=max_tokens))
    got = teng.generate(prompts, SamplingParams(max_tokens=max_tokens))
    assert got == want
    st, jst = teng.stats(), jeng.stats()
    for key in ("requests_finished", "tokens_generated", "preemptions",
                "prefill_chunks", "draft_tokens_proposed",
                "draft_tokens_accepted"):
        assert st[key] == jst[key], key
    if kw["kv"] == "paged":
        assert st["pages_free"] == st["pages_total"]
    if case == "preemption":
        assert st["preemptions"] > 0


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_admission_never_rewrites_a_shared_page(tparams, prefill_chunk):
    """A's first full prefix page is overwritten with a sentinel; B, which
    shares it, is then admitted (whole or in chunks). The page still holds
    the sentinel: B's writes for it went to the dump page."""
    eng = LLMEngine(CFG, params=tparams, device="cpu", kv="paged",
                    page_size=16, max_batch=2, max_seq=64,
                    prefill_chunk=prefill_chunk)
    eng.add_request(HEAD + [5, 6], SamplingParams(max_tokens=16))
    for _ in range(4):  # 3 chunks of 16 at most
        eng.step()
    (req_a,) = eng._active.values()
    page = req_a.pages[0]
    for name in ("k", "v"):
        eng.cache[name][:, page] = 1234.0
    eng.add_request(HEAD + [9], SamplingParams(max_tokens=8))
    for _ in range(4):
        eng.step()
    assert len(eng._active) == 2
    req_b = next(r for r in eng._active.values() if r is not req_a)
    assert req_b.pages[:2] == req_a.pages[:2]  # both full pages shared
    for name in ("k", "v"):
        assert bool((eng.cache[name][:, page] == 1234.0).all()), name
    while eng.has_unfinished():
        eng.step()


def test_temperature_sampling_in_vocab_and_greedy_repeatable(tparams):
    def run(temperature, seed, speculate=0):
        eng = LLMEngine(CFG, params=tparams, device="cpu", max_batch=2,
                        max_seq=64, page_size=16, seed=seed,
                        speculate=speculate)
        sp = SamplingParams(max_tokens=12, temperature=temperature)
        return eng.generate([[1, 2, 3], [4, 5, 6, 4, 5, 6, 4, 5]], sp)

    for speculate in (0, 2):
        outs = run(1.0, 0, speculate)
        assert all(len(o) == 12 for o in outs)
        assert all(0 <= t < CFG.vocab_size for o in outs for t in o)
        assert run(1.0, 0, speculate) == outs  # seeded generator
    assert run(1.0, 1) != run(1.0, 0)
    assert run(0.0, 0) == run(0.0, 1)  # greedy ignores the seed


def test_abort_and_streaming_deltas(tparams):
    eng = LLMEngine(CFG, params=tparams, device="cpu", max_batch=2,
                    max_seq=64, page_size=16)
    keep = eng.add_request([1, 2, 3], SamplingParams(max_tokens=4),
                           stream=True)
    drop = eng.add_request([4, 5], SamplingParams(max_tokens=30))
    done = {}

    def step():
        for fin in eng.step():
            done[fin["request_id"]] = fin["tokens"]
        streamed.extend(eng.drain_deltas().get(keep, []))

    streamed = []
    step()
    assert eng.abort_request(drop)
    assert not eng.abort_request("no-such-request")
    while eng.has_unfinished():
        step()
    assert drop not in done and len(done[keep]) == 4
    assert streamed == done[keep]
    st = eng.stats()
    assert st["requests_aborted"] == 1
    assert st["pages_free"] == st["pages_total"]
