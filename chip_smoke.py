#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card and builds the CUDA kernels from csrc/ (nvcc,
         one process per source, all at once); prints each kernel
         function's registers and spills, and any ptxas warning.
Phase 1  holds each kernel against its plain PyTorch version on the card:
         the paged attention kernel (bf16 and fp32, batch 8 and 64,
         K = 1 and 4, an inactive slot, a wider table, poisoned cells
         past every slot's frontier), the flash forward (O and LSE,
         S in {512, 1000, 1024, 2048}, causal and full; 1024 is the
         dense prefill's own shape; 32 query / 8 KV heads), then at the
         bench preset's 8 / 4 heads the flash forward again and the
         flash backward (dq, dk, dv), each at the training step's B=16
         S=2048 and at S=1000, 512, 200 and 64 (200: a ragged second
         128-row tile; 64: shorter than one tile), causal and full, bf16
         (the tensor-core kernels, held per element and by norm:
         FLASH_BF16_TOL, FLASH_BF16_NORM) and fp32 (the scalar ones); the
         bf16 backward runs twice on the same inputs and its run-to-run
         max |ddq| must stay within one bf16 step (dq is summed with
         atomics).
Phase 2  serves 8 requests on a paged LLMEngine at full llama3_8b width
         and depth (random bf16 weights from a seed), greedy, then 8
         repetitive prompts with speculate=3; checks the paged kernel's
         launch count, recomputes the first decode step through the
         plain path, and checks that admitting a request that shares a
         live request's prefix pages leaves those pages byte-identical.
Phase 3  serves one 1024-token prompt on a dense LLMEngine; checks that
         the flash kernel ran once per layer in prefill and recomputes
         the prefill logits through the plain path.
Phase 4  frees the serving model and trains the bench preset (24 layers,
         d 1024, flash attention, remat "flash_qkv", fp32 parameters,
         bf16 compute, AdamW with a bf16 first moment) on 16 x 2049
         tokens: two warm-up steps and four timed ones; checks the
         losses and gradient norms and the launches (24 forward + 24
         backward per step; 48 forward under remat "full"), profiles one
         step (every flash_fwd* kernel counts as F1, every flash_bwd*
         kernel as F2; either at 0 ms fails), and holds one batch-2
         gradient step through the kernels against one through the plain
         dense attention, in bf16 and fp32.
Timing   each kernel at the main path's shapes (CUDA events, cold L2):
         its time, its plain version's, its bound, and for the flash
         kernels the time of PyTorch's scaled_dot_product_attention
         (forward; forward + backward minus forward for the backward).

Prints a ``{"kernels": [...]}`` line (the flash forward twice: "flash_fwd"
at the prefill's shape, "flash_fwd_train" at the training step's, each
with its own launches and error), the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero; without a CUDA device it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# The bf16 flash kernels against their plain versions. Both sides round at
# the same points (q pre-scaled, p and ds to bf16 before their products)
# from fp32 values summed in other orders, so a rounded p or ds may land one
# bf16 step apart: a few bf16 steps of p . v or ds . k per element, and a
# norm-relative error of a few 1e-3 at most. The limits sit 1.5 and 2 times
# above the worst readings (PERF.md), which each comparison prints. A key
# tile or one group head's share left out fails them by far; O or dq off
# by 1% everywhere fails them too, where the paged kernel's atol = rtol =
# 2e-2 would pass it.
FLASH_BF16_TOL = (2e-3, 1e-2)  # atol, rtol per element
FLASH_BF16_NORM = 5e-3  # limit of ||got - want|| / ||want||


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


def ptxas_summary(log):
    """Each kernel function's registers and spills from nvcc's
    ``-Xptxas -v`` output, then any ptxas warning line and any note of a
    performance loss (ptxas reports serialised wgmma as an info line)."""
    rows, warnings, name, spills = [], [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            found = re.search(r"[a-z_]*kernel", mangled)
            name = found.group(0) if found else mangled
            if "bfloat16" in mangled:
                name += "<bf16>"
            elif re.search(r"kernelIf", mangled):
                name += "<fp32>"
        elif "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            spills = f"spills {stores}/{loads} B"
        elif "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            rows.append(f"{name} {regs}, {spills}")
        elif "warning" in line.lower() or "Performance" in line:
            warnings.append(f"{name}: {line.strip()}")
    return rows + warnings


def compare(name, got, want, atol, rtol, norm=None):
    """Fail unless |got - want| <= atol + rtol * |want| everywhere and,
    where ``norm`` is given, ||got - want|| / ||want|| <= norm; prints the
    largest |got - want| - rtol * |want| (held to atol) and returns the
    max abs error."""
    got, want = got.float(), want.float()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs()
    excess = float((err - rtol * want.abs()).max()) if finite else math.inf
    ok = finite and excess <= atol
    max_err = float(err.max()) if finite else math.inf
    rel = ""
    if norm is not None:
        r = float(err.norm() / want.norm()) if finite else math.inf
        ok = ok and r <= norm
        rel = f", norm-rel {r:.3e} (limit {norm})"
    print(f"  {name}: max_abs_err={max_err:.3e}, beyond rtol {excess:.3e} "
          f"(atol={atol}, rtol={rtol}; max|want|="
          f"{float(want.abs().max()):.3e}){rel} {'ok' if ok else 'FAIL'}")
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
    # Paged bf16 tolerance: both sides read the same bf16 inputs; they
    # differ in where p is rounded to bf16 (online per page vs one block)
    # and in the bf16 rounding of the output, each <= 2^-8 relative.
    # fp32 tolerance: the same arithmetic in another summation order.
    tol = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
    # The flash kernels round where their plain versions do.
    flash_tol = dict(tol)
    flash_tol[torch.bfloat16] = FLASH_BF16_TOL
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
        atol, rtol = flash_tol[dtype]
        norm = FLASH_BF16_NORM if dtype == torch.bfloat16 else None
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
                e = compare(label + " O", o, o_ref, atol, rtol, norm)
                # LSE is fp32 from the same rounded inputs in both.
                compare(label + " LSE", lse, lse_ref, 1e-4, 1e-4)
                if dtype == torch.bfloat16:
                    errs["flash"] = max(errs["flash"], e)
    for key, e in flash_bwd_checks(flash_tol, device).items():
        errs[key] = max(errs.get(key, 0.0), e)
    return errs


def flash_inputs(b, s, dtype, seed, h=8, hkv=4, d=128, device="cuda"):
    """q, k, v and a gradient dO at the bench preset's head layout, drawn
    on the device from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in shapes]


def flash_bwd_checks(tol, device="cuda"):
    """At the bench preset's heads (8 query, 4 KV): the forward kernel's O
    and LSE against its plain version, then dq, dk, dv of the backward
    kernel against its plain version on those same O and LSE, at the
    flash tolerances of phase 1 (bf16: ``FLASH_BF16_TOL`` per element and
    ``FLASH_BF16_NORM``; fp32: 1e-4, the same arithmetic in another
    summation order).

    The bf16 backward sums dq with fp32 atomics in no fixed order: it
    runs a second time on the same inputs, and the largest |ddq| between
    the two runs must stay within 2^-8 * max |dq| (fp32 sums in two
    orders, each rounded once to bf16, differ by at most one bf16 step).

    Returns the worst bf16 errors: "flash_train" (forward O at the
    training step's B=16 S=2048), "flash" (forward O at the other shapes)
    and "flash_bwd" (dq, dk, dv at every shape), and "dq_spread" (the
    largest run-to-run |ddq|)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_forward,
        flash_attention_reference,
    )

    worst = {"flash_train": 0.0, "flash": 0.0, "flash_bwd": 0.0,
             "dq_spread": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = tol[dtype]
        norm = FLASH_BF16_NORM if dtype == torch.bfloat16 else None
        # 16 x 2048: the training step's shape; 1000: a ragged last tile;
        # 200: a ragged second 128-row tile; 64: less than one tile.
        for b, s in ((16, 2048), (2, 1000), (2, 512), (2, 200), (2, 64)):
            q, k, v, do = flash_inputs(b, s, dtype, seed=s, device=device)
            fwd_key = "flash_train" if (b, s) == (16, 2048) else "flash"
            for causal in (True, False):
                label = (f"B={b} S={s} H=8/4 causal={causal} "
                         f"{str(dtype)[6:]}")
                o, lse = flash_attention_forward(q, k, v, causal)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal)
                sync()
                e_fwd = compare(f"flash {label} O", o, o_ref, atol, rtol,
                                norm)
                compare(f"flash {label} LSE", lse, lse_ref, 1e-4, 1e-4)
                del o_ref, lse_ref
                got = flash_attention_backward(q, k, v, o, lse, do, causal)
                want = flash_attention_backward_reference(
                    q, k, v, o, lse, do, causal
                )
                sync()
                e_bwd = max(
                    compare(f"flash bwd {label} {name}", a, w, atol, rtol,
                            norm)
                    for name, a, w in zip(("dq", "dk", "dv"), got, want)
                )
                if dtype == torch.bfloat16:
                    worst[fwd_key] = max(worst[fwd_key], e_fwd)
                    worst["flash_bwd"] = max(worst["flash_bwd"], e_bwd)
                    again = flash_attention_backward(q, k, v, o, lse, do,
                                                     causal)[0]
                    spread = float((again.float() - got[0].float()).abs()
                                   .max())
                    limit = 2**-8 * float(got[0].float().abs().max())
                    print(f"  flash bwd {label} dq run to run: max |ddq| "
                          f"{spread:.3e} (limit {limit:.3e})")
                    check(spread <= limit,
                          f"flash bwd {label}: dq moves {spread:.3e} run to "
                          f"run, more than one bf16 step")
                    worst["dq_spread"] = max(worst["dq_spread"], spread)
                    del again
                del got, want
    return worst


# ------------------------------------------------------------ main path
def reset_counts():
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from ray_tpu_torch.ops.paged_attention import paged_attention

    paged_attention.launches = 0
    flash_attention_forward.launches = 0
    flash_attention_backward.launches = 0


def counts():
    """Launches since reset_counts: (paged, flash forward, flash
    backward)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from ray_tpu_torch.ops.paged_attention import paged_attention

    return (paged_attention.launches, flash_attention_forward.launches,
            flash_attention_backward.launches)


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
    p_launch, _, _ = counts()
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
    p_spec, _, _ = counts()
    st_spec = spec.stats()
    check(all(o is not None and len(o) == max_tokens for o in spec_outs),
          "a speculative request did not finish")
    check(p_spec == cfg.n_layers * st_spec["decode_steps"],
          f"paged kernel launched {p_spec} times for "
          f"{st_spec['decode_steps']} verify steps x {cfg.n_layers} layers")
    del spec
    prefix_pages_check(cfg, params, prompts[-1], seed, device)
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


def prefix_pages_check(cfg, params, prompt, seed, device="cuda",
                       page_size=64):
    """Admit A (130 tokens: two full pages), then B, which shares A's two
    full pages but is prefilled in another bucket (528 tokens). The same
    tokens prefilled at two bucket lengths need not give byte-identical
    K/V on the card (cuBLAS may tile the two products differently), so
    the engine must not write the pages B shares: check that A's shared
    pages are byte-identical before and after B's admission."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams

    eng = LLMEngine(cfg, max_batch=2, max_seq=2048, params=params,
                    kv="paged", page_size=page_size, seed=seed,
                    device=device)
    sp = SamplingParams(max_tokens=8)
    eng.add_request(prompt[:130], sp)
    eng.step()
    (req_a,) = eng._active.values()
    shared = req_a.pages[:2]
    before = {n: eng.cache[n][:, shared].clone() for n in ("k", "v")}
    eng.add_request(prompt[:128] + prompt[200:600], sp)
    eng.step()
    sync()
    check(len(eng._active) == 2, "the second request was not admitted")
    req_b = next(r for r in eng._active.values() if r is not req_a)
    check(req_b.pages[:2] == shared,
          "the second request does not share the prefix pages")
    same = all(torch.equal(eng.cache[n][:, shared], before[n])
               for n in ("k", "v"))
    print(f"  shared-prefix pages of a live request after a second "
          f"admission (bucket 256 vs 1024): "
          f"{'byte-identical' if same else 'REWRITTEN'}")
    check(same, "admitting a request rewrote a live request's shared pages")
    while eng.has_unfinished():
        eng.step()


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
    _, f_launch, _ = counts()
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


# ------------------------------------------------------------ training
def rel_err(got, want):
    """||got - want|| / ||want||, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def grad_step_checks(cfg, params, tokens):
    """One gradient step through the flash kernels against one through
    the plain dense attention (under which "flash_qkv" acts as "full"), on
    the same weights and tokens, in fp32 and in bf16 compute: the loss,
    the gradient norm and every leaf's gradient, as relative (Frobenius)
    errors.

    fp32: the two differ in summation order only: <= 1e-3.
    bf16: the two round attention's probabilities, outputs and gradients
    to bf16 at different places (2^-8 each) through 24 layers, so each is
    held against the fp32 dense gradient instead: the kernels' error may
    be at most twice the plain path's, plus 1e-3."""
    from ray_tpu_torch.ops.flash_attention import make_flash_attention
    from ray_tpu_torch.train.step import _flatten, global_norm, grad_step

    batch = {"tokens": tokens}
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        for path, attn_cfg, attn_fn in (
            ("kernels", c, make_flash_attention()),
            ("dense", dataclasses.replace(c, attn_impl="dense"), None),
        ):
            m, g = grad_step(attn_cfg, attn_fn)(params, batch)
            vals = {"loss": m["loss"], "grad_norm": global_norm(g)}
            vals.update(("/".join(p), t) for p, t in _flatten(g))
            runs[path, dtype] = vals
    sync()

    def errs(a, b):
        return {k: rel_err(runs[a][k], runs[b][k]) for k in runs[a]}

    f32, bf16 = torch.float32, torch.bfloat16
    ref = ("dense", f32)
    tight = errs(("kernels", f32), ref)
    kern, plain = errs(("kernels", bf16), ref), errs(("dense", bf16), ref)
    direct = errs(("kernels", bf16), ("dense", bf16))
    slack = {k: kern[k] - 2 * plain[k] for k in kern}
    for label, e, worst, ok in (
        ("fp32, kernels vs plain dense", tight, max(tight, key=tight.get),
         all(v <= 1e-3 for v in tight.values())),
        ("bf16, kernels vs fp32 dense", kern, max(slack, key=slack.get),
         all(v <= 1e-3 for v in slack.values())),
    ):
        ok = ok and all(math.isfinite(v) for v in e.values())
        print(f"  grad step B={tokens.shape[0]} {label}: worst {worst} "
              f"{e[worst]:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"grad step {label}: {worst} off by {e[worst]:.3e}")
    worst = max(direct, key=direct.get)
    losses = [float(runs[path, bf16]["loss"]) for path in ("kernels", "dense")]
    print(f"  bf16 plain dense vs fp32 dense: worst {max(plain.values()):.3e}"
          f"; bf16 kernels vs bf16 plain dense: worst {worst} "
          f"{direct[worst]:.3e}; loss {losses[0]:.6f} vs {losses[1]:.6f}")
    return direct[worst]


def profile_train(step, state, data, step_s):
    """Device time of one steady train step by kernel class, from a
    torch.profiler trace, against the unprofiled step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, data)
        sync()
    classes = {"flash_fwd": 0.0, "flash_bwd": 0.0, "matmul": 0.0,
               "other": 0.0}
    others, flash = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        # F1 and F2 by prefix, whatever the kernel (bf16 or fp32 route;
        # F2's preprocess, main and convert kernels).
        kernel = re.search(r"flash_(fwd|bwd)\w*kernel", name)
        if kernel:
            cls = f"flash_{kernel.group(1)}"
            flash[kernel.group(0)] = (flash.get(kernel.group(0), 0.0)
                                      + ev.self_device_time_total / 1e3)
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet",
                                      "xmma", "cublas")):
            cls = "matmul"
        else:
            cls = "other"
            others[ev.key[:60]] = ev.self_device_time_total / 1e3
        classes[cls] += ev.self_device_time_total / 1e3  # ms
    busy = sum(classes.values())
    wall = step_s * 1e3
    check(classes["flash_fwd"] > 0 and classes["flash_bwd"] > 0,
          f"the profile finds no F1 or F2 time: {classes}")
    print("  flash kernels in the profile: "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in sorted(flash.items())))
    print("  profiled train step: device "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items())
          + f"; busy {busy:.1f} ms of {wall:.1f} ms wall, idle "
          f"{1 - busy / wall:.1%}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    print("  largest of 'other': "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in top))
    return state, dict(classes, busy=busy, idle_share=1 - busy / wall)


def time_ce_and_optimizer(cfg, opt, state, batch, seq):
    """The chunked cross-entropy (forward + backward, from random hidden
    states) and one optimizer update (zero gradients: the same work), each
    timed alone with CUDA events."""
    from ray_tpu_torch.train.step import (
        _flatten,
        _unflatten,
        chunked_cross_entropy,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    hidden = torch.randn((batch, seq, cfg.d_model), generator=g,
                         device="cuda").to(cfg.dtype).requires_grad_()
    head = state.params["lm_head"]
    targets = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                            device="cuda")

    def ce():
        loss = chunked_cross_entropy(hidden, head, targets, cfg.dtype)
        torch.autograd.grad(loss, (hidden, head))

    ce_ms = time_ms(ce, iters=5, warmup=1)
    grads = _unflatten((path, torch.zeros_like(t))
                       for path, t in _flatten(state.params))
    opt_ms = time_ms(lambda: opt.apply(state.params, grads, state.opt_state),
                     iters=5, warmup=1)
    print(f"  timed alone: chunked CE forward + backward {ce_ms:.1f} ms, "
          f"optimizer update {opt_ms:.1f} ms")
    return ce_ms, opt_ms


def phase4(seed, device="cuda", batch=16, seq=2048, warmup=2, steps=4):
    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train.step import (
        init_train_state,
        jit_train_step,
        make_optimizer,
    )

    print("phase 4: training, bench preset")
    cfg = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    n = cfg.n_layers
    opt = make_optimizer(total_steps=1000, mu_dtype=torch.bfloat16)
    state = init_train_state(cfg, opt, seed=seed, device=device)
    step = jit_train_step(cfg, opt)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    ).to(device)
    data = {"tokens": tokens}
    losses, norms, wall = [], [], []
    launches = [0, 0]
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        dt = time.perf_counter() - t0
        _, f1, f2 = counts()
        check(f1 == n and f2 == n,
              f"train step {i}: {f1} forward and {f2} backward flash "
              f"launches for {n} layers under remat flash_qkv")
        launches[0] += f1
        launches[1] += f2
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i >= warmup:
            wall.append(dt)
        print(f"  step {i}: loss {losses[-1]:.4f}, grad_norm "
              f"{norms[-1]:.4f}, {dt * 1e3:.1f} ms, flash launches "
              f"{f1} + {f2}")
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + norms),
          "a loss or gradient norm is not finite")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 0.5,
          f"step 0 loss {losses[0]:.4f} is not within 0.5 of "
          f"ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}")
    step_s = sum(wall) / len(wall)
    tps = batch * seq / step_s
    share = tps * cfg.flops_per_token(seq) / BF16_FLOPS
    print(f"  train: {tps:.1f} tokens/s ({step_s * 1e3:.1f} ms per step of "
          f"{batch} x {seq} tokens, {cfg.flops_per_token(seq) / 1e9:.3f} "
          f"GFLOP/token), {share:.2%} of the dense bf16 peak; peak memory "
          f"{peak / 2**30:.2f} GiB")

    # Full remat replays every layer's forward kernel in backward.
    full = jit_train_step(dataclasses.replace(cfg, remat="full"), opt)
    reset_counts()
    t0 = time.perf_counter()
    state, m = full(state, data)
    sync()
    full_s = time.perf_counter() - t0
    _, f1, f2 = counts()
    check(f1 == 2 * n and f2 == n,
          f"remat full: {f1} forward and {f2} backward flash launches for "
          f"{n} layers")
    check(math.isfinite(float(m["loss"])), "remat full: non-finite loss")
    print(f"  remat full: one step {full_s * 1e3:.1f} ms, flash launches "
          f"{f1} + {f2}")

    state, prof = profile_train(step, state, data, step_s)
    ce_ms, opt_ms = time_ce_and_optimizer(cfg, opt, state, batch, seq)
    # The same weights through the kernels and through the plain dense
    # attention, at batch 2 (the dense path keeps [B, H, S, S] scores).
    grad_err = grad_step_checks(cfg, state.params, tokens[:2])
    return {"cfg": cfg, "f1_launches": launches[0],
            "f2_launches": launches[1], "tokens_per_s": tps,
            "peak_share": share, "step_ms": step_s * 1e3,
            "full_step_ms": full_s * 1e3, "peak_gib": peak / 2**30,
            "losses": losses, "profile": prof, "ce_ms": ce_ms,
            "opt_ms": opt_ms, "grad_err": grad_err}


# ------------------------------------------------------------ timing
def bound_of(nbytes, flops):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def print_rows(rows):
    for name, r in rows.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']})")


def timing_serving(cfg, positions, errs):
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
    # QK and PV, each 2 flops per product
    bound_ms, by = bound_of(nbytes, 4 * h * dh * keys)
    rows["paged_attention"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
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
    bound_ms, by = bound_of(
        (2 * q.numel() + k.numel() + v.numel()) * elt + h * s * 4,
        4 * h * dh * (s * (s + 1) // 2),
    )
    rows["flash_fwd"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=library_ms, max_abs_err=errs["flash"],
    )
    print_rows(rows)
    return rows


def timing_training(cfg, errs, batch=16, seq=2048):
    """F1 and F2 at the training step's shape (bench preset, B=16,
    S=2048, causal, bf16). The library time of the backward is autograd
    through scaled_dot_product_attention minus its forward."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_forward,
        flash_attention_reference,
    )

    print(f"timing at the training step's shapes (B={batch}, S={seq})")
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, do = flash_inputs(batch, seq, cfg.dtype, seed=9, h=h, hkv=hkv,
                               d=dh)
    elt = torch.finfo(cfg.dtype).bits // 8
    tri = seq * (seq + 1) // 2  # causal (query, key) pairs per head
    lse_bytes = batch * h * seq * 4
    rows = {}
    ms = time_ms(lambda: flash_attention_forward(q, k, v, True))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, True),
                       iters=3, warmup=1)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    library_ms = time_ms(sdpa)
    bound_ms, by = bound_of(
        (2 * q.numel() + k.numel() + v.numel()) * elt + lse_bytes,
        4 * batch * h * dh * tri,
    )
    rows["flash_fwd_train"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=library_ms, max_abs_err=errs["flash_train"],
    )

    o, lse = flash_attention_forward(q, k, v, True)
    ms = time_ms(lambda: flash_attention_backward(q, k, v, o, lse, do, True))
    plain_ms = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, o, lse, do, True), iters=3, warmup=1)
    for t in (qt, kt, vt):
        t.requires_grad_()
    fwd_ms = time_ms(sdpa)
    fwd_bwd_ms = time_ms(
        lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    # Inputs q, k, v, O, dO, LSE read once; dq, dk, dv written once.
    bound_ms, by = bound_of(
        (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * elt
        + lse_bytes,
        10 * batch * h * dh * tri,
    )
    rows["flash_bwd"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=fwd_bwd_ms - fwd_ms, max_abs_err=errs["flash_bwd"],
    )
    print_rows(rows)
    print(f"  library backward: scaled_dot_product_attention forward + "
          f"backward {fwd_bwd_ms:.4f} ms minus forward {fwd_ms:.4f} ms")
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
        print(f"  {name}: " + "; ".join(ptxas_summary(log)))

    errs = phase1()

    cfg = PRESETS["llama3_8b"]
    t0 = time.time()
    params = init_params(cfg, args.seed, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    print(f"weights: {cfg.num_params() / 1e9:.2f} B parameters in "
          f"{cfg.dtype}, drawn in {time.time() - t0:.1f} s")
    p2 = phase2(cfg, params, args.seed)
    p3 = phase3(cfg, params, args.seed)
    rows = timing_serving(cfg, p2["first_positions"], errs)
    print(f"decode: {p2['decode_tokens_per_s']:.1f} tokens/s at batch 8, "
          f"speculative {p2['spec_tokens_per_s']:.1f} tokens/s; "
          f"TTFT mean {p2['ttft_s_mean']:.3f} s, max {p2['ttft_s_max']:.3f}"
          f" s (8 prompts admitted in one step); dense 1024-token TTFT "
          f"{p3['ttft_s']:.3f} s [{card}]")
    print(f"serving peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # The serving model goes before the trainer's state comes.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    p4 = phase4(args.seed)
    rows.update(timing_training(p4["cfg"], errs))
    prof = p4["profile"]
    print(f"train: {p4['tokens_per_s']:.1f} tokens/s, "
          f"{p4['peak_share']:.2%} of dense bf16 peak, step "
          f"{p4['step_ms']:.1f} ms (remat full {p4['full_step_ms']:.1f} ms),"
          f" peak memory {p4['peak_gib']:.2f} GiB; device per step: flash "
          f"forward {prof['flash_fwd']:.1f} ms, flash backward "
          f"{prof['flash_bwd']:.1f} ms, matmuls {prof['matmul']:.1f} ms, "
          f"other {prof['other']:.1f} ms, idle {prof['idle_share']:.1%}; "
          f"CE alone {p4['ce_ms']:.1f} ms, optimizer alone "
          f"{p4['opt_ms']:.1f} ms; bf16 F2 dq run to run max |ddq| "
          f"{errs['dq_spread']:.3e} [{card}]")
    print(f"run took {time.time() - t_start:.1f} s")
    # One row per kernel and main-path shape: the forward kernel runs in
    # the dense prefill (phase 3) and in training (phase 4).
    launches = {"paged_attention": p2["launches"],
                "flash_fwd": p3["launches"],
                "flash_fwd_train": p4["f1_launches"],
                "flash_bwd": p4["f2_launches"]}
    fwd = ("ray_tpu_torch/csrc/flash_fwd.cu",
           "ray_tpu/ops/pallas/flash_attention.py:48")
    meta = {
        "paged_attention": ("ray_tpu_torch/csrc/paged_attention.cu",
                            "ray_tpu/ops/pallas/paged_attention.py:59"),
        "flash_fwd": fwd,
        "flash_fwd_train": fwd,
        "flash_bwd": ("ray_tpu_torch/csrc/flash_bwd.cu",
                      "ray_tpu/ops/pallas/flash_attention.py:187"),
    }
    check(rows.keys() == meta.keys(),
          f"timed rows {sorted(rows)} are not the kernels {sorted(meta)}")
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
