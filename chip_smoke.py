#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card and builds the CUDA kernels from csrc/ (nvcc,
         one process per source, all at once).
Phase 1  holds each kernel against its plain PyTorch version on the card:
         the paged attention kernel (bf16 and fp32, batch 8 and 64,
         K = 1 and 4, an inactive slot, a wider table, poisoned cells
         past every slot's frontier) and the flash forward (O and LSE,
         S in {512, 1000, 1024, 2048}, causal and full; 1024 is the
         dense prefill's own shape).
Phase 2  serves 8 requests on a paged LLMEngine at full llama3_8b width
         and depth (random bf16 weights from a seed), greedy, then 8
         repetitive prompts with speculate=3; checks the paged kernel's
         launch count and recomputes the first decode step through the
         plain path.
Phase 3  serves one 1024-token prompt on a dense LLMEngine; checks that
         the flash kernel ran once per layer in prefill and recomputes
         the prefill logits through the plain path.
Timing   each kernel at the main path's shapes (CUDA events, cold L2):
         its time, its plain version's, its bound, and for the flash
         forward the time of PyTorch's scaled_dot_product_attention.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero; without a CUDA device it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, atol, rtol):
    """Fail unless |got - want| <= atol + rtol * |want| everywhere;
    returns the max abs error."""
    got, want = got.float(), want.float()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs()
    ok = finite and bool((err <= atol + rtol * want.abs()).all())
    max_err = float(err.max()) if finite else float("inf")
    print(f"  {name}: max_abs_err={max_err:.3e} (atol={atol}, rtol={rtol})"
          f" {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} exceeds its tolerance")
    return max_err


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, with L2 flushed before each call
    (the main path reaches each kernel after other layers' weights have
    passed through the cache)."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ------------------------------------------------------------ paged case
def paged_case(b, kq, lengths, max_pages, dtype, seed, page_size=64,
               n_heads=32, n_kv=8, head_dim=128, inactive=(),
               extra_pages=8, poison=True, device="cuda"):
    """Inputs of one paged-attention call: pages shuffled across the pool,
    a table per slot covering positions .. positions + K - 1, slots in
    ``inactive`` all -1 at position 0, and (``poison``) V cells past each
    slot's frontier set to 1e4 so that any unmasked stale cell shows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    positions = torch.tensor(lengths, dtype=torch.int32)
    need = [(int(p) + kq - 1) // page_size + 1 for p in lengths]
    n_pages = sum(need) + 1 + extra_pages
    perm = torch.randperm(n_pages - 1, generator=g) + 1  # page 0 = dump
    tables = torch.full((b, max_pages), -1, dtype=torch.int32)
    start_pos = torch.full((n_pages,), -1, dtype=torch.long)
    owner_lim = torch.zeros((n_pages,), dtype=torch.long)
    nxt = 0
    for i in range(b):
        if i in inactive:
            positions[i] = 0
            continue
        ids = perm[nxt: nxt + need[i]]
        nxt += need[i]
        tables[i, : need[i]] = ids.to(torch.int32)
        start_pos[ids] = torch.arange(need[i]) * page_size
        owner_lim[ids] = int(positions[i]) + kq
    shape = (n_pages, n_kv, page_size, head_dim)
    q = torch.randn((b, kq, n_heads, head_dim), generator=g)
    k_pool = torch.randn(shape, generator=g)
    v_pool = torch.randn(shape, generator=g)
    if poison:
        cell = start_pos[:, None] + torch.arange(page_size)[None, :]
        stale = (start_pos[:, None] >= 0) & (cell >= owner_lim[:, None])
        v_pool.masked_fill_(stale[:, None, :, None], 1e4)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k_pool.to(dtype=dtype, **to),
            v_pool.to(dtype=dtype, **to), tables.to(**to),
            positions.to(**to))


def phase1(device="cuda"):
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
        flash_attention_reference,
    )
    from ray_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    print("phase 1: kernels against their plain versions")
    rng = np.random.default_rng(1)
    # bf16 tolerance: both sides read the same bf16 inputs; they differ in
    # where p is rounded to bf16 (online per page vs one block) and in the
    # bf16 rounding of the output, each <= 2^-8 relative.
    # fp32 tolerance: the same arithmetic in another summation order.
    tol = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
    errs = {"paged": 0.0, "flash": 0.0}
    cases = []
    for b in (8, 64):
        lengths = rng.integers(1, 2000, size=b)
        lengths[:4] = [0, 63, 64, 127][: min(4, b)]  # page boundaries
        for kq in (1, 4):
            cases.append((f"B={b} K={kq}", b, kq, lengths.tolist(), 32, ()))
    cases.append(("B=8 K=1 inactive slot 3", 8, 1,
                  rng.integers(1, 2000, size=8).tolist(), 32, (3,)))
    cases.append(("B=8 K=4 wide table (64 pages)", 8, 4,
                  rng.integers(1, 2000, size=8).tolist(), 64, ()))
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = tol[dtype]
        for label, b, kq, lengths, max_pages, inactive in cases:
            args = paged_case(b, kq, lengths, max_pages, dtype, seed=b + kq,
                              inactive=inactive, device=device)
            got = paged_attention(*args)
            want = paged_attention_reference(*args)
            sync()
            e = compare(f"paged {label} {str(dtype)[6:]}", got, want,
                        atol, rtol)
            if dtype == torch.bfloat16:
                errs["paged"] = max(errs["paged"], e)

    g = torch.Generator(device="cpu").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = tol[dtype]
        for s in (512, 1000, 1024, 2048):  # 1024: phase 3's prefill
            q = torch.randn((1, s, 32, 128), generator=g)
            k = torch.randn((1, s, 8, 128), generator=g)
            v = torch.randn((1, s, 8, 128), generator=g)
            q, k, v = (t.to(device=device, dtype=dtype) for t in (q, k, v))
            for causal in (True, False):
                o, lse = flash_attention_forward(q, k, v, causal)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal)
                sync()
                label = f"flash S={s} causal={causal} {str(dtype)[6:]}"
                e = compare(label + " O", o, o_ref, atol, rtol)
                # LSE is fp32 from the same rounded inputs in both.
                compare(label + " LSE", lse, lse_ref, 1e-4, 1e-4)
                if dtype == torch.bfloat16:
                    errs["flash"] = max(errs["flash"], e)
    return errs


# ------------------------------------------------------------ main path
def reset_counts():
    from ray_tpu_torch.ops.flash_attention import flash_attention_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    paged_attention.launches = 0
    flash_attention_forward.launches = 0


def counts():
    from ray_tpu_torch.ops.flash_attention import flash_attention_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    return paged_attention.launches, flash_attention_forward.launches


def serve(engine, prompts, sampling):
    """Submit all prompts, step to completion; returns (outputs, step
    wall times, tokens emitted per step, finished dicts)."""
    order = {engine.add_request(p, sampling): i
             for i, p in enumerate(prompts)}
    outs = [None] * len(prompts)
    fins = []
    step_s, step_tokens = [], []
    while engine.has_unfinished():
        before = engine.stats()["tokens_generated"]
        t0 = time.perf_counter()
        for fin in engine.step():
            outs[order[fin["request_id"]]] = fin["tokens"]
            fins.append(fin)
        sync()
        step_s.append(time.perf_counter() - t0)
        step_tokens.append(engine.stats()["tokens_generated"] - before)
    return outs, step_s, step_tokens, fins


def logits_tolerance(name, got, want):
    """bf16 logits after 32 layers: the kernel and the plain path round
    attention outputs at different places, so allow 5% of the logits'
    range and require the same argmax where the top-2 gap exceeds it."""
    scale = float(want.abs().max())
    atol = 0.05 * scale
    compare(name, got, want, atol, 0.0)
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[clear].all()), f"{name}: argmax differs on a clear row")


def phase2(cfg, params, seed, device="cuda", max_seq=2048, page_size=64,
           lengths=(20, 63, 64, 65, 200, 511, 900, 1500), max_tokens=32):
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.paged_kv import paged_decode

    print("phase 2: paged engine")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    sp = SamplingParams(max_tokens=max_tokens)
    eng = LLMEngine(cfg, max_batch=8, max_seq=max_seq, params=params,
                    kv="paged", page_size=page_size, seed=seed,
                    device=device)
    check(eng.paged_attn_kernel, "paged engine did not select the kernel")
    rec = {}
    decode = eng._decode_paged

    def recording(params, tokens, pool, tables, positions, temps, gen):
        out = decode(params, tokens, pool, tables, positions, temps, gen)
        if not rec:
            rec.update(tokens=tokens.clone(), tables=tables.clone(),
                       positions=positions.clone(), temps=temps.clone(),
                       logits=out[1].clone())
        return out

    # Warm-up pass (cuBLAS picks its kernels per shape on first use), so
    # the measured pass times the steady state.
    serve(eng, prompts, SamplingParams(max_tokens=2))
    eng._decode_paged = recording
    steps0 = eng.stats()["decode_steps"]
    reset_counts()
    outs, step_s, step_tokens, fins = serve(eng, prompts, sp)
    p_launch, _ = counts()
    st = eng.stats()
    steps = st["decode_steps"] - steps0
    check(all(o is not None and len(o) == max_tokens for o in outs),
          "a paged request did not finish with max_tokens tokens")
    check(p_launch == cfg.n_layers * steps,
          f"paged kernel launched {p_launch} times for "
          f"{steps} decode steps x {cfg.n_layers} layers")
    check(st["active_requests"] == 0 and st["pages_free"] == st["pages_total"],
          "paged engine leaked slots or pages")
    # All 8 requests are admitted in the first step; the rest are decode.
    decode_tps = sum(step_tokens[1:]) / sum(step_s[1:])
    ttft = [f["timing"]["ttft_s"] for f in fins]

    # The first decode step again, through the plain gather path.
    g = torch.Generator(device=device).manual_seed(seed)
    _s, plain_logits, _p = paged_decode(
        eng.params, rec["tokens"], eng.cache, rec["tables"],
        rec["positions"], rec["temps"], g, cfg=cfg, use_kernel=False,
    )
    logits_tolerance("first decode step logits, kernel vs plain",
                     rec["logits"], plain_logits)
    check(bool(torch.isfinite(plain_logits).all()), "non-finite logits")
    profile_decode(eng, prompts, sum(step_s[1:]) / len(step_s[1:]))
    del eng

    # Speculative decoding on repetitive prompts.
    pattern = rng.integers(0, cfg.vocab_size, 12).tolist()
    spec_prompts = [(pattern * (n // 12 + 1))[: max(n, 24)]
                    for n in lengths]
    spec = LLMEngine(cfg, max_batch=8, max_seq=max_seq, params=params,
                     kv="paged", page_size=page_size, seed=seed,
                     speculate=3, device=device)
    reset_counts()
    spec_outs, spec_s, spec_tokens, _ = serve(spec, spec_prompts, sp)
    p_spec, _ = counts()
    st_spec = spec.stats()
    check(all(o is not None and len(o) == max_tokens for o in spec_outs),
          "a speculative request did not finish")
    check(p_spec == cfg.n_layers * st_spec["decode_steps"],
          f"paged kernel launched {p_spec} times for "
          f"{st_spec['decode_steps']} verify steps x {cfg.n_layers} layers")
    del spec
    prefix_identical = prefix_pages_check(cfg, params, prompts[-1], device)
    print(f"  greedy: {steps} decode steps, "
          f"{p_launch} kernel launches; speculative: "
          f"{st_spec['decode_steps']} verify steps, {p_spec} launches, "
          f"acceptance {st_spec.get('draft_acceptance_rate', 0.0)}")
    return {
        "launches": p_launch + p_spec,
        "decode_tokens_per_s": decode_tps,
        "ttft_s_mean": float(np.mean(ttft)),
        "ttft_s_max": float(np.max(ttft)),
        "spec_tokens_per_s": sum(spec_tokens[1:]) / sum(spec_s[1:]),
        "first_positions": rec["positions"].cpu().tolist(),
        "prefix_identical": prefix_identical,
    }


def profile_decode(engine, prompts, step_wall_s, n_steps=4):
    """Print the device time of a few steady decode steps by kernel class,
    from a torch.profiler trace, against the unprofiled step's wall time."""
    from ray_tpu_torch.llm.engine import SamplingParams
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        engine.add_request(p, SamplingParams(max_tokens=n_steps + 2))
    engine.step()  # admissions and the first decode stay outside
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        sync()
    while engine.has_unfinished():
        engine.step()
    classes = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side events; kernels and copies are CUDA
        name = ev.key.lower()
        if "paged_attention_kernel" in name:
            cls = "paged_attention"
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet",
                                      "xmma", "cublas")):
            cls = "matmul"
        else:
            cls = "other"
        classes[cls] += ev.self_device_time_total  # microseconds
    per_step = {k: v / n_steps / 1e3 for k, v in classes.items()}  # ms
    busy = sum(per_step.values())
    print(f"  profiled decode step (batch 8): device "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in per_step.items())
          + f"; device busy {busy:.2f} ms of {step_wall_s * 1e3:.2f} ms "
          f"wall ({busy / (step_wall_s * 1e3):.1%})")


def prefix_pages_check(cfg, params, prompt, device="cuda", page_size=64):
    """Prefix sharing reuses a page prefilled at one bucket length for a
    prompt prefilled at another; report whether the shared pages come out
    byte-identical when the same 128 tokens are prefilled in a 128- and a
    512-token bucket (cuBLAS may tile the two products differently)."""
    from ray_tpu_torch.llm.paged_kv import init_paged_kv, paged_prefill

    pool = init_paged_kv(cfg, 11, page_size, device=device)
    toks = torch.tensor(prompt[:512], device=device)[None]
    paged_prefill(params, toks[:, :128], pool,
                  torch.arange(1, 3, device=device), cfg=cfg,
                  n_write_pages=2)
    paged_prefill(params, toks, pool, torch.arange(3, 11, device=device),
                  cfg=cfg, n_write_pages=8)
    diff = max(float((pool[n][:, 1:3].float() - pool[n][:, 3:5].float())
                     .abs().max()) for n in ("k", "v"))
    print(f"  shared-prefix pages, bucket 128 vs 512: max |diff| {diff:.3e}"
          f" ({'byte-identical' if diff == 0 else 'NOT identical'})")
    return diff == 0


def phase3(cfg, params, seed, device="cuda", max_seq=2048, prompt_len=1024,
           max_tokens=32):
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.kv_cache import forward_prefill, init_kv_cache

    print("phase 3: dense engine")
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
    eng = LLMEngine(cfg, max_batch=1, max_seq=max_seq, params=params,
                    kv="dense", seed=seed, device=device)
    rec = {}
    prefill = eng._prefill

    def recording(params, tokens, cache, slot):
        out = prefill(params, tokens, cache, slot)
        rec.update(tokens=tokens.clone(), logits=out[0].clone())
        return out

    eng._prefill = recording
    reset_counts()
    outs, _step_s, _tok, fins = serve(
        eng, [prompt], SamplingParams(max_tokens=max_tokens)
    )
    _, f_launch = counts()
    check(outs[0] is not None and len(outs[0]) == max_tokens,
          "the dense request did not finish")
    check(f_launch == cfg.n_layers,
          f"flash kernel launched {f_launch} times in one prefill of "
          f"{cfg.n_layers} layers")
    del eng
    plain_logits, _ = forward_prefill(
        params, rec["tokens"], init_kv_cache(cfg, 1, max_seq, device),
        0, cfg, use_flash=False,
    )
    logits_tolerance("prefill logits, flash kernel vs plain",
                     rec["logits"][0, :prompt_len],
                     plain_logits[0, :prompt_len])
    return {"launches": f_launch, "ttft_s": fins[0]["timing"]["ttft_s"]}


# ------------------------------------------------------------ timing
def timing(cfg, positions, errs):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
        flash_attention_reference,
    )
    from ray_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    print("timing at the main path's shapes")
    rows = {}
    h, hkv, dh, page = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 64
    # P1: the first decode step of phase 2 (batch 8, K = 1, 32-page table).
    args = paged_case(len(positions), 1, positions, 32, cfg.dtype, seed=7,
                      n_heads=h, n_kv=hkv, head_dim=dh, poison=False)
    ms = time_ms(lambda: paged_attention(*args))
    plain_ms = time_ms(lambda: paged_attention_reference(*args))
    live_pages = sum(p // page + 1 for p in positions)
    elt = torch.finfo(cfg.dtype).bits // 8
    nbytes = (2 * live_pages * hkv * page * dh * elt  # K and V pages
              + 2 * args[0].numel() * elt  # q in, out
              + args[3].numel() * 4 + args[4].numel() * 4)
    keys = sum(p + 1 for p in positions)
    flops = 4 * h * dh * keys  # QK and PV, each 2 flops per product
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    rows["paged_attention"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound[by], bound_by=by,
        library_ms=None, max_abs_err=errs["paged"],
    )
    # F1: the dense prefill of phase 3 (B = 1, S = 1024, causal).
    s = 1024
    g = torch.Generator(device="cpu").manual_seed(8)
    q = torch.randn((1, s, h, dh), generator=g).to("cuda", cfg.dtype)
    k = torch.randn((1, s, hkv, dh), generator=g).to("cuda", cfg.dtype)
    v = torch.randn((1, s, hkv, dh), generator=g).to("cuda", cfg.dtype)
    ms = time_ms(lambda: flash_attention_forward(q, k, v, True))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + h * s * 4
    flops = 4 * h * dh * (s * (s + 1) // 2)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    rows["flash_fwd"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound[by], bound_by=by,
        library_ms=library_ms, max_abs_err=errs["flash"],
    )
    for name, r in rows.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']})")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ray_tpu_torch import _build
    from ray_tpu_torch.models.llama import PRESETS, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build()
    print(f"  kernels built in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "Used" in line})
        print(f"  {name}: ptxas {'; '.join(regs)}")

    errs = phase1()

    cfg = PRESETS["llama3_8b"]
    t0 = time.time()
    params = init_params(cfg, args.seed, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    print(f"weights: {cfg.num_params() / 1e9:.2f} B parameters in "
          f"{cfg.dtype}, drawn in {time.time() - t0:.1f} s")
    p2 = phase2(cfg, params, args.seed)
    p3 = phase3(cfg, params, args.seed)
    rows = timing(cfg, p2["first_positions"], {**errs})

    print(f"decode: {p2['decode_tokens_per_s']:.1f} tokens/s at batch 8, "
          f"speculative {p2['spec_tokens_per_s']:.1f} tokens/s; "
          f"TTFT mean {p2['ttft_s_mean']:.3f} s, max {p2['ttft_s_max']:.3f}"
          f" s (8 prompts admitted in one step); dense 1024-token TTFT "
          f"{p3['ttft_s']:.3f} s [{card}]")
    print(f"shared-prefix pages byte-identical across buckets: "
          f"{p2['prefix_identical']}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB; run took {time.time() - t_start:.1f} s")
    launches = {"paged_attention": p2["launches"],
                "flash_fwd": p3["launches"]}
    meta = {
        "paged_attention": ("ray_tpu_torch/csrc/paged_attention.cu",
                            "ray_tpu/ops/pallas/paged_attention.py:59"),
        "flash_fwd": ("ray_tpu_torch/csrc/flash_fwd.cu",
                      "ray_tpu/ops/pallas/flash_attention.py:48"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
