#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card and builds the CUDA kernels from csrc/ (nvcc,
         one process per source, all at once); prints each kernel
         function's registers and spills, and any ptxas warning.
Phase 1  holds each kernel against its plain PyTorch versions on the card:
         the paged attention kernel at llama3_8b's heads (32 / 8 of 128)
         and at mini's (12 / 4 of 64: padded rows) (bf16 and fp32, batch
         8 and 64,
         K = 1 and 4, an inactive slot, a wider table, K = 4 one to three
         cells before a split boundary, batch 1 and 4 at up to 16k tokens
         in 256-page tables, poisoned cells past every slot's frontier;
         bf16 held to the split plain version at the wrapper's split by
         PAGED_BF16_TOL and PAGED_BF16_NORM, and to the one-block plain
         version at 2e-2), the flash forward (O and LSE,
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
         atomics). The same at moe_bench's 16 / 8 heads of head_dim 64,
         at mini's 12 / 4 heads of 64 (its dense prefill's 1024 tokens,
         S = 1000 and 200), and in bf16 at the bench_8b.py recipe's B=2
         S=4096 with 32 / 8 heads of 128; a head_dim of 96 must be
         refused by all three kernels.
Phase 2  serves 8 requests on a paged LLMEngine at full llama3_8b width
         and depth (random bf16 weights from a seed), greedy, then 8
         repetitive prompts with speculate=3; checks the paged kernel's
         launch count, profiles a few decode and verify steps (device
         time by kernel class against the wall), recomputes the first
         decode step through the plain path, and checks that admitting
         a request that shares a live request's prefix pages leaves
         those pages byte-identical; holds every greedy and speculative
         token stream to the plain path's, teacher-forced
         (stream_check). Then the same for mini at full width and depth
         (12 layers, head_dim 64).
Phase 3  serves one 1024-token prompt on a dense LLMEngine; checks that
         the flash kernel ran once per layer in prefill and recomputes
         the prefill logits through the plain path; llama3_8b, then
         mini.
Phase 4  frees the serving model and trains the bench preset (24 layers,
         d 1024, flash attention, remat "flash_qkv", fp32 parameters,
         bf16 compute, AdamW with a bf16 first moment) on 16 x 2049
         tokens: two warm-up steps and four timed ones; checks the
         losses and gradient norms and the launches (24 forward + 24
         backward per step); runs a forward + backward in each of the
         eight remat modes on the same weights (time of the second of two
         calls, peak memory, launches per F1_PER_LAYER: 48 forward under
         "full", "attn" and "dots"; loss against flash_qkv's); profiles
         one step (every flash_fwd* kernel counts as F1, every flash_bwd*
         kernel as F2; either at 0 ms fails), and holds one batch-2
         gradient step through the kernels against one through the plain
         dense attention, in bf16 and fp32.
Phase 5  trains moe_bench at full width and depth (6 layers, d 1024, 16 / 8
         heads of 64, 4 experts, top-2; remat "full") on 16 x 2049
         tokens: 12 forward + 6 backward flash launches per step, a
         falling loss and a positive aux loss; profiles one step; holds
         moe_ffn in fp32 to the dense top-k ensemble (the reference's
         oracle).
Phase 6  the bench_8b.py recipe: 4 full llama3_8b layers, vocab 8192,
         remat "full", 2 x 4097 tokens, 2 warm-up and 5 timed steps.
Phase 7  the training loop on the bench preset at full width and depth:
         a token file written from the seed, read through TokenDataset
         (shuffled windows of the file, prefetched, the ragged tail
         dropped), 6 steps; again with a CheckpointManager save at step 3,
         a restore into a fresh state (bit for bit the saved one) and
         steps 4-6, whose losses must equal the uninterrupted run's
         within 2^-8 relative; save and restore seconds and bytes. Then
         train/memory.py's plan beside each peak it prices (phase 4's
         remat full, dots and none, phase 6's recipe): within 15%, and
         fitting the card, since each ran.
Phase 8  the sharded path. (a) F1/F2 at a tp rank's local shapes (the
         bench preset at tp=2: 4/2 heads, B=16 S=2048; llama3_8b at tp=8:
         4/1, B=2 S=4096; moe_bench at tp=2: 8/4 of 64) and P1 at
         llama3_8b tp=2 (16/4) and tp=8 (4/1) and mini tp=4 (3/1 of 64),
         held to their plain versions in fp32 on the same bf16 inputs
         (FLASH_ORACLE_TOL, PAGED_ORACLE_TOL) and timed.
         (b) two ranks spawned on the one card over gloo (correctness
         only: gloo copies every collective through host memory):
         llama3_8b at full width and depth served with mesh {"tp": 2}
         (each rank's pool holds 4 of the 8 KV heads; streams held by
         stream_check), then the bench preset's first two steps under
         {"fsdp": 2} and {"tp": 2} with no learning-rate warm-up, held to
         the same steps in one process (losses within TWO_RANK_LOSS_REL,
         gradient norms within TWO_RANK_NORM_REL), with each rank's flash launches and peak
         memory beside plan_memory.
Phase 9  two ranks on the one card over gloo (correctness only), each
         run against the same work in one process: (a) the bench preset
         pipelined (parallel/pipeline.py) over {"pp": 2}, 4 microbatches
         of phase 4's 16 x 2048 batch, 12 layers per stage (flash,
         remat "flash_qkv"), the embedding before the pipeline and the
         final norm + chunked CE as the loss head: the loss within
         TWO_RANK_LOSS_REL and each parameter's gradient norm within
         TWO_RANK_NORM_REL, (M + P - 1) x 12 = 60 F1 and F2 launches per
         rank; F1/F2 at the microbatch's shape (B=4) held to their plain
         versions in fp32 (FLASH_ORACLE_*) and timed; (b) two bench steps
         under {"sp": 2} with flash (the sequence gathered over sp);
         (c) under {"tp": 2} with remat "flash_qkv_ffn8", every int8
         value and scale the step's kept op makes (on every
         INT8_ROW_STRIDE-th row) equal to the whole rows' quantization;
         (d) moe_bench under {"sp": 2} with 2048-token routing groups
         that span the ranks (MOE_LOSS_REL, MOE_AUX_REL, MOE_NORM_REL);
         (e) phase 8b's fsdp = 2 run on
         make_multislice_mesh({}, {"fsdp": 2}) over two one-rank fake
         slices: step 0's loss bit for bit phase 8b's. Every phase prints
         its seconds.
Timing   each kernel at the main path's shapes (CUDA events, cold L2):
         its time, its plain version's, its bound (P1 also at the verify
         step's K = 4 and at batch 64, on lines of their own), and for the flash
         kernels the time of PyTorch's scaled_dot_product_attention
         (forward; forward + backward minus forward for the backward).

Prints a ``{"kernels": [...]}`` line (the paged kernel twice,
"paged_attention" at llama3_8b's first decode step and
"paged_attention_d64" at mini's; the flash forward three times:
"flash_fwd" at the prefill's shape, "flash_fwd_train" at the bench
training step's, "flash_fwd_train_d64" at moe_bench's; the backward twice,
"flash_bwd" and "flash_bwd_d64"; and the tp=2 shapes phase 8b runs,
"paged_attention_tp2", "flash_fwd_train_tp2" and "flash_bwd_tp2", with
both ranks' launches, and the pipeline's microbatch shape phase 9a runs,
"flash_fwd_train_pp" and "flash_bwd_pp", with both ranks' launches; each
with its own launches and error; the other phase 8a shapes on a line of
their own; phase 9b's sp-gathered F1/F2 run at phase 4's shape, whose row
carries phase 4's launches),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero;
without a CUDA device it exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import re
import subprocess
import sys
import time
import types

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
# by 1% everywhere fails them too, where atol = rtol = 2e-2 would pass it.
FLASH_BF16_TOL = (2e-3, 1e-2)  # atol, rtol per element
FLASH_BF16_NORM = 5e-3  # limit of ||got - want|| / ||want||
# The bf16 paged kernel against paged_attention_split_reference at the
# wrapper's own split: the same rounding points (p to bf16 against each
# page's running max, per split; the fp32 combine), fp32 sums in other
# orders, so a rounded p may land one bf16 step apart and the output one
# bf16 step (within 1e-2 |want|). Worst readings over phase 1's cases:
# 1.1e-4 beyond 1e-2 |want|, norm-relative 3.3e-4 (PERF.md); the limits
# sit 1.8 and 3 times above them. A split left out of the combine, a page
# left out of a split or the exp(m_s - M) rescale left out fails them by
# two orders of magnitude (paged_attention_chip.py mutants).
PAGED_BF16_TOL = (2e-4, 1e-2)  # atol, rtol per element
PAGED_BF16_NORM = 1e-3  # limit of ||got - want|| / ||want||
# Phase 8a holds the bf16 kernels at a tp rank's head layouts to their
# plain versions in fp32 on the same bf16 inputs (the exact function of
# what each kernel is given), not to the plain bf16 versions: at
# llama3_8b's tp=8 layout (4/1 heads) the kernel and the plain bf16
# version differed beyond the limits above at one element each (F2's dk at
# B=2 S=4096, P1 at B=64 K=4). Both round O, dq, dk, dv and P1's output to
# bf16, and p and ds before their products, so each sits a few bf16 steps
# per element from the fp32 result, the plain bf16 versions as far as the
# kernels. Sound kernels over phase 8a's layouts read at most 1.14e-2 beyond
# 1e-2 |want| and 3.4e-3 norm-relative (F2; F1 4.3e-3 and 2.8e-3), P1
# 2.2e-3 and 2.2e-3; the limits sit 1.75-1.85 times above them. Each
# planted fault (a key tile, the rescale, delta, a dq tile, a dk step, the
# causal mask one key late; a split, a page, P1's rescale) reads at least
# 0.48 beyond and 0.29 norm-relative at every layout (sharded_chip.py
# kernel-faults; PERF.md PR 7).
FLASH_ORACLE_TOL = (2e-2, 1e-2)  # atol, rtol per element
FLASH_ORACLE_NORM = 6e-3  # limit of ||got - want|| / ||want||
PAGED_ORACLE_TOL = (4e-3, 1e-2)  # atol, rtol per element
PAGED_ORACLE_NORM = 4e-3  # limit of ||got - want|| / ||want||


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
            # integer template arguments (P1's rows per block)
            name += "".join(f"<{n}>" for n in re.findall(r"Li(\d+)E",
                                                         mangled))
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


def distance(got, want, rtol):
    """The readings compare holds, as text, for a line that holds nothing:
    the largest |got - want| - rtol * |want| and the norm-relative error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return (f"beyond rtol {float((err - rtol * want.abs()).max()):.3e} "
            f"(rtol={rtol}), norm-rel {float(err.norm() / want.norm()):.3e}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, with L2 flushed before each call
    (the main path reaches each kernel after other layers' weights have
    passed through the cache). The stream is held ~0.5 ms after the flush,
    so that the host's time to issue the call (Python, ctypes) passes
    while the device is still busy and not between the two events."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # clock cycles
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


def paged_checks(device="cuda", heads=(32, 8, 128), oracle=False):
    """P1 against its plain versions in every case, bf16 and fp32, at one
    head layout ``heads`` = (query heads, KV heads, head_dim): llama3_8b's
    by default, mini's (12, 4, 64) for the head_dim-64 build, where 3 query
    rows per KV head at decode and 12 at K = 4 leave padded rows in the
    kernel's row blocks of 4 and 16.

    bf16 is held to the split plain version at the wrapper's own split
    (``PAGED_BF16_TOL`` per element, ``PAGED_BF16_NORM`` by norm) and to
    the one-block plain version at atol = rtol = 2e-2 (p rounded against
    the row's max there, against each page's running max in the kernel);
    fp32 to both at 1e-4 (the same arithmetic in another summation
    order). With ``oracle`` (phase 8a) bf16 is held instead to the plain
    version in fp32 on the same bf16 inputs (``PAGED_ORACLE_TOL``,
    ``PAGED_ORACLE_NORM``), and the split plain version's own distance
    from it is printed beside. Returns the worst bf16 error against the
    yardstick."""
    from ray_tpu_torch.ops.paged_attention import (
        kernel_split,
        paged_attention,
        paged_attention_reference,
        paged_attention_split_reference,
    )

    rng = np.random.default_rng(1)
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
    # K = 4 one to three cells before a split boundary (two pages per
    # split at 32 pages, four at 64): rows of the last live split that see
    # none of its cells.
    cases.append(("B=8 K=4 split boundaries (32 pages)", 8, 4,
                  [61, 62, 63, 125, 126, 127, 189, 1021], 32, ()))
    cases.append(("B=8 K=4 split boundaries (64 pages)", 8, 4,
                  [125, 126, 127, 253, 254, 255, 381, 3000], 64, ()))
    # Long context, 256-page tables: many live splits per slot.
    cases.append(("B=1 K=1 long (256 pages)", 1, 1, [16000], 256, ()))
    for kq in (1, 4):
        lengths = rng.integers(1, 16384 - kq, size=4)
        lengths[0] = 16384 - kq
        cases.append((f"B=4 K={kq} long (256 pages)", 4, kq,
                      lengths.tolist(), 256, ()))
    worst = {"err": 0.0, "excess": 0.0, "norm": 0.0}
    h, hkv, dh = heads
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, kq, lengths, max_pages, inactive in cases:
            args = paged_case(b, kq, lengths, max_pages, dtype, seed=b + kq,
                              n_heads=h, n_kv=hkv, head_dim=dh,
                              inactive=inactive, device=device)
            pps = kernel_split(*args[:2], args[3]) if device == "cuda" else 1
            got = paged_attention(*args)
            split = paged_attention_split_reference(*args, pps)
            single = paged_attention_reference(*args)
            sync()
            name = f"paged H={h}/{hkv} D={dh} {label} {str(dtype)[6:]}"
            if dtype == torch.bfloat16:
                if oracle:
                    atol, rtol = PAGED_ORACLE_TOL
                    want = paged_attention_reference(
                        *(t.float() for t in args[:3]), *args[3:])
                    e = compare(f"{name} vs fp32", got, want, atol, rtol,
                                PAGED_ORACLE_NORM)
                    print(f"    plain bf16 (split) vs fp32: "
                          f"{distance(split, want, rtol)}")
                else:
                    atol, rtol = PAGED_BF16_TOL
                    want = split
                    e = compare(f"{name} vs split ({pps} pages/split)", got,
                                split, atol, rtol, PAGED_BF16_NORM)
                    compare(f"{name} vs one block", got, single, 2e-2, 2e-2)
                err = (got.float() - want.float()).abs()
                worst["err"] = max(worst["err"], e)
                worst["excess"] = max(worst["excess"], float(
                    (err - rtol * want.float().abs()).max()))
                worst["norm"] = max(worst["norm"], float(
                    err.norm() / want.float().norm()))
            else:
                compare(f"{name} vs split ({pps} pages/split)", got, split,
                        1e-4, 1e-4)
                compare(f"{name} vs one block", got, single, 1e-4, 1e-4)
    print(f"  paged H={h}/{hkv} D={dh} bf16 vs "
          f"{'fp32' if oracle else 'split'}, worst: max_abs_err "
          f"{worst['err']:.3e}, beyond rtol {worst['excess']:.3e}, norm-rel "
          f"{worst['norm']:.3e}")
    return worst["err"]


def phase1(device="cuda"):
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
        flash_attention_reference,
    )

    print("phase 1: kernels against their plain versions")
    # fp32 tolerance: the same arithmetic in another summation order.
    tol = {torch.bfloat16: FLASH_BF16_TOL, torch.float32: (1e-4, 1e-4)}
    errs = {"paged": paged_checks(device),
            "paged_d64": paged_checks(device, heads=MINI_HEADS),
            "flash": 0.0}

    g = torch.Generator(device="cpu").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = tol[dtype]
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
    # The bench preset's heads (F1/F2 at head_dim 128), moe_bench's (head
    # dim 64: the training shape, ragged S, fp32), mini's (head_dim 64 with
    # n_rep = 3: its dense prefill's 1024 tokens, ragged S) and the
    # bench_8b.py recipe's llama3_8b layers at B=2 S=4096 (bf16, its main
    # path).
    for kw in (dict(),
               dict(heads=MOE_HEADS, tag="_d64"),
               dict(heads=MINI_HEADS, shapes=((1, 1024), (2, 1000), (2, 200)),
                    train=(1, 1024), tag="_mini"),
               dict(heads=LLAMA8B_HEADS, shapes=((2, 4096),),
                    dtypes=(torch.bfloat16,), train=(2, 4096), tag="_8b")):
        for key, e in flash_bwd_checks(tol, device, **kw).items():
            errs[key] = max(errs.get(key, 0.0), e)
    if device == "cuda":
        head_dim_refused()
    return errs


def head_dim_refused():
    """A CUDA tensor of a head size the kernels are not built for (96)
    raises in the three wrappers, and the C entry points refuse it too."""
    # The modules, not the functions the package re-exports under their
    # names.
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("ray_tpu_torch.ops.paged_attention")
    q = torch.zeros((1, 128, 2, 96), dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros((2, 1, 128), device="cuda")
    pq = torch.zeros((2, 1, 8, 96), dtype=torch.bfloat16, device="cuda")
    pool = torch.zeros((3, 2, 64, 96), dtype=torch.bfloat16, device="cuda")
    tables = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    pos = torch.zeros((2,), dtype=torch.int32, device="cuda")
    for call in (lambda: fa.flash_attention_forward(q, q, q),
                 lambda: fa.flash_attention_backward(q, q, q, q, lse, q),
                 lambda: pa.paged_attention(pq, pool, pool, tables, pos)):
        try:
            call()
        except ValueError as e:
            check("head_dim" in str(e), f"head_dim 96 refused for {e}")
        else:
            raise SmokeFailure("a head_dim 96 CUDA tensor was not refused")
    stream = torch.cuda.current_stream().cuda_stream
    err = fa._kernel()(1, *(q.data_ptr(),) * 4, lse.data_ptr(), 1, 128, 2,
                       2, 96, 1, stream)
    check(err != 0, "rtt_flash_fwd accepted head_dim 96")
    ws = torch.zeros((4096,), dtype=torch.float32, device="cuda")
    p_err = pa._kernel()(1, pq.data_ptr(), pool.data_ptr(), pool.data_ptr(),
                         tables.data_ptr(), pos.data_ptr(), pq.data_ptr(),
                         ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 2, 1, 8,
                         2, 96, 64, 2, 4, 1, 96**-0.5, stream)
    check(p_err != 0, "rtt_paged_attention accepted head_dim 96")
    print(f"  head_dim 96: the three wrappers raise, rtt_flash_fwd returns "
          f"{err}, rtt_paged_attention {p_err}")


def flash_inputs(b, s, dtype, seed, h=8, hkv=4, d=128, device="cuda"):
    """q, k, v and a gradient dO (by default at the bench preset's head
    layout), drawn on the device from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in shapes]


# (query heads, KV heads, head_dim): the bench preset, moe_bench, mini
# (served paged and dense) and llama3_8b (served, and the bench_8b.py
# recipe).
BENCH_HEADS, MOE_HEADS, LLAMA8B_HEADS = (8, 4, 128), (16, 8, 64), (32, 8, 128)
MINI_HEADS = (12, 4, 64)
# Shapes (B, S) of the flash checks: the training step's 16 x 2048, a
# ragged last tile (1000), a ragged second 128-row tile (200) and less
# than one tile (64).
FLASH_SHAPES = ((16, 2048), (2, 1000), (2, 512), (2, 200), (2, 64))


def flash_bwd_checks(tol, device="cuda", heads=BENCH_HEADS,
                     shapes=FLASH_SHAPES, dtypes=(torch.bfloat16,
                                                  torch.float32),
                     train=(16, 2048), tag="", oracle=False):
    """At one head layout (by default the bench preset's 8 query, 4 KV
    heads of 128): the forward kernel's O and LSE against its plain
    version, then dq, dk, dv of the backward kernel against its plain
    version on those same O and LSE, at the flash tolerances of phase 1
    (bf16: ``FLASH_BF16_TOL`` per element and ``FLASH_BF16_NORM``; fp32:
    1e-4, the same arithmetic in another summation order). With
    ``oracle`` (phase 8a) the bf16 O, dq, dk and dv are held instead to
    the plain versions in fp32 on the same bf16 inputs
    (``FLASH_ORACLE_TOL``, ``FLASH_ORACLE_NORM``), and the plain bf16
    versions' own distance from them is printed beside.

    The bf16 backward sums dq with fp32 atomics in no fixed order: it
    runs a second time on the same inputs, and the largest |ddq| between
    the two runs must stay within 2^-8 * max |dq| (fp32 sums in two
    orders, each rounded once to bf16, differ by at most one bf16 step).

    Returns the worst bf16 errors, each key ending in ``tag``:
    "flash_train" (forward O at the shape ``train``), "flash" (forward O
    at the other shapes) and "flash_bwd" (dq, dk, dv at every shape), and
    "dq_spread" (the largest run-to-run |ddq|)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_forward,
        flash_attention_reference,
    )

    h, hkv, d = heads
    worst = {f"flash_train{tag}": 0.0, f"flash{tag}": 0.0,
             f"flash_bwd{tag}": 0.0, "dq_spread": 0.0}
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        atol, rtol = tol[dtype]
        norm = FLASH_BF16_NORM if bf16 else None
        if bf16 and oracle:
            (atol, rtol), norm = FLASH_ORACLE_TOL, FLASH_ORACLE_NORM
        for b, s in shapes:
            q, k, v, do = flash_inputs(b, s, dtype, seed=s, h=h, hkv=hkv,
                                       d=d, device=device)
            fwd_key = ("flash_train" if (b, s) == train else "flash") + tag
            for causal in (True, False):
                label = (f"B={b} S={s} H={h}/{hkv} D={d} causal={causal} "
                         f"{str(dtype)[6:]}")
                o, lse = flash_attention_forward(q, k, v, causal)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal)
                if bf16 and oracle:
                    f32 = [t.float() for t in (q, k, v, do)]
                    o_32, lse_32 = flash_attention_reference(*f32[:3],
                                                             causal)
                sync()
                if bf16 and oracle:
                    e_fwd = compare(f"flash {label} O vs fp32", o, o_32,
                                    atol, rtol, norm)
                    print(f"    plain bf16 O vs fp32: "
                          f"{distance(o_ref, o_32, rtol)}")
                else:
                    e_fwd = compare(f"flash {label} O", o, o_ref, atol, rtol,
                                    norm)
                compare(f"flash {label} LSE", lse, lse_ref, 1e-4, 1e-4)
                del o_ref, lse_ref
                got = flash_attention_backward(q, k, v, o, lse, do, causal)
                want = flash_attention_backward_reference(
                    q, k, v, o, lse, do, causal
                )
                sync()
                if bf16 and oracle:
                    exact = flash_attention_backward_reference(
                        *f32[:3], o_32, lse_32, f32[3], causal)
                    del f32, o_32, lse_32
                    e_bwd = 0.0
                    for name, a, w, x in zip(("dq", "dk", "dv"), got, want,
                                             exact):
                        e_bwd = max(e_bwd, compare(
                            f"flash bwd {label} {name} vs fp32", a, x, atol,
                            rtol, norm))
                        print(f"    plain bf16 {name} vs fp32: "
                              f"{distance(w, x, rtol)}")
                    del exact
                else:
                    e_bwd = max(
                        compare(f"flash bwd {label} {name}", a, w, atol,
                                rtol, norm)
                        for name, a, w in zip(("dq", "dk", "dv"), got, want)
                    )
                if bf16:
                    worst[fwd_key] = max(worst[fwd_key], e_fwd)
                    worst["flash_bwd" + tag] = max(worst["flash_bwd" + tag],
                                                   e_bwd)
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


SERVE_LENGTHS = (20, 63, 64, 65, 200, 511, 900, 1500)


def serving_prompts(cfg, rng, lengths=SERVE_LENGTHS):
    """Phase 2's prompts: one of each length, token ids drawn from
    ``rng``."""
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def phase2(cfg, params, seed, device="cuda", max_seq=2048, page_size=64,
           lengths=SERVE_LENGTHS, max_tokens=32, name="llama3_8b"):
    """Paged serving of ``cfg``: plain greedy, then speculative; every
    emitted token of both is held to the plain path's greedy choice
    (:func:`stream_check`)."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.paged_kv import paged_decode

    print(f"phase 2: paged engine, {name}")
    rng = np.random.default_rng(seed)
    prompts = serving_prompts(cfg, rng, lengths)
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
    profile_decode(spec, spec_prompts, sum(spec_s[1:]) / len(spec_s[1:]),
                   label="verify")
    check(all(o is not None and len(o) == max_tokens for o in spec_outs),
          "a speculative request did not finish")
    check(p_spec == cfg.n_layers * st_spec["decode_steps"],
          f"paged kernel launched {p_spec} times for "
          f"{st_spec['decode_steps']} verify steps x {cfg.n_layers} layers")
    del spec
    stream_check(cfg, params, prompts, outs, "greedy", device)
    stream_check(cfg, params, spec_prompts, spec_outs, "speculative", device)
    prefix_pages_check(cfg, params, prompts[-1], seed, device)
    print(f"  greedy: {steps} decode steps, "
          f"{p_launch} kernel launches; speculative: "
          f"{st_spec['decode_steps']} verify steps, {p_spec} launches, "
          f"acceptance {st_spec.get('draft_acceptance_rate', 0.0)}")
    return {
        "launches": p_launch + p_spec,
        "outs": outs,
        "decode_tokens_per_s": decode_tps,
        "ttft_s_mean": float(np.mean(ttft)),
        "ttft_s_max": float(np.max(ttft)),
        "spec_tokens_per_s": sum(spec_tokens[1:]) / sum(spec_s[1:]),
        "first_positions": rec["positions"].cpu().tolist(),
    }


def stream_check(cfg, params, prompts, outs, label, device="cuda"):
    """Each served token stream against the plain path, teacher-forced:
    prompt + stream through the plain dense prefill (no kernel) in one
    pass; at every position the emitted token must be the plain argmax up
    to the bf16 tolerance of logits_tolerance (its logit within 2 x 5% of
    the logits' range of the row's max), so a stream equals the plain
    path's wherever the plain path's choice is clear. Prints how many
    tokens are its exact argmax."""
    from ray_tpu_torch.llm.kv_cache import forward_prefill, init_kv_cache

    exact = total = 0
    for prompt, out in zip(prompts, outs):
        toks = list(prompt) + list(out[:-1])
        cache = init_kv_cache(cfg, 1, len(toks), device)
        logits, _ = forward_prefill(
            params, torch.tensor([toks], device=device), cache, 0, cfg,
            use_flash=False,
        )
        z = logits[0, len(prompt) - 1:].float()  # row i predicts out[i]
        atol = 0.05 * float(z.abs().max())
        chosen = z.gather(1, torch.tensor(out, device=device)[:, None])[:, 0]
        ok = chosen >= z.max(dim=-1).values - 2 * atol
        check(bool(ok.all()), f"{label} stream: a token is not the plain "
              f"path's choice at positions {(~ok).nonzero().tolist()}")
        exact += int((z.argmax(-1) == torch.tensor(out, device=device))
                     .sum())
        total += len(out)
        del cache, logits
    print(f"  {label} streams vs the plain path (teacher-forced): "
          f"{total} tokens within tolerance, {exact} its exact argmax")


def profile_decode(engine, prompts, step_wall_s, n_steps=4, label="decode"):
    """Print the device time of a few steady decode (or, on a speculative
    engine, verify) steps by kernel class, from a torch.profiler trace,
    against the unprofiled step's wall time."""
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
    print(f"  profiled {label} step (batch 8): device "
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
           max_tokens=32, name="llama3_8b"):
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.kv_cache import forward_prefill, init_kv_cache

    print(f"phase 3: dense engine, {name}")
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


def train_run(cfg, seed, device, batch, seq, warmup, steps, f1, f2, label):
    """``warmup`` + ``steps`` train steps of ``cfg`` (fp32 parameters from
    ``seed``, AdamW with a bf16 first moment) on one batch of ``batch`` x
    ``seq + 1`` tokens drawn from the seed, each ending in a sync; every
    step must launch the flash forward ``f1`` and the backward ``f2``
    times. Returns the state, the step function, the batch, per-step
    losses (and MoE aux losses), the mean timed step, its tokens/s, the
    peak memory of the timed steps and the launches of all steps."""
    from ray_tpu_torch.train.step import (
        init_train_state,
        jit_train_step,
        make_optimizer,
    )

    opt = make_optimizer(total_steps=1000, mu_dtype=torch.bfloat16)
    state = init_train_state(cfg, opt, seed=seed, device=device)
    step = jit_train_step(cfg, opt)
    rng = np.random.default_rng(seed)
    data = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))).to(device)}
    losses, aux, norms, wall = [], [], [], []
    launches = [0, 0]
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()  # allocated and reserved
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        dt = time.perf_counter() - t0
        _, n1, n2 = counts()
        check(n1 == f1 and n2 == f2,
              f"{label} step {i}: {n1} forward and {n2} backward flash "
              f"launches, expected {f1} and {f2}")
        launches[0] += n1
        launches[1] += n2
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "aux_loss" in m:
            aux.append(float(m["aux_loss"]))
        if i >= warmup:
            wall.append(dt)
        print(f"  step {i}: loss {losses[-1]:.4f}"
              + (f", aux_loss {aux[-1]:.5f}" if aux else "")
              + f", grad_norm {norms[-1]:.4f}, {dt * 1e3:.1f} ms, flash "
              f"launches {n1} + {n2}")
    check(all(math.isfinite(x) for x in losses + norms + aux),
          f"{label}: a loss or gradient norm is not finite")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 0.5,
          f"{label}: step 0 loss {losses[0]:.4f} is not within 0.5 of "
          f"ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}")
    step_s = sum(wall) / len(wall)
    peak = torch.cuda.max_memory_allocated()
    return dict(state=state, step=step, data=data, opt=opt, losses=losses,
                aux=aux, step_s=step_s, tps=batch * seq / step_s, peak=peak,
                slack=torch.cuda.max_memory_reserved() - peak,
                launches=launches)


def phase4(seed, device="cuda", batch=16, seq=2048, warmup=2, steps=4):
    from ray_tpu_torch.models.llama import PRESETS

    print("phase 4: training, bench preset")
    cfg = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    n = cfg.n_layers
    r = train_run(cfg, seed, device, batch, seq, warmup, steps, n, n,
                  "remat flash_qkv")
    state, step, data, opt = r["state"], r["step"], r["data"], r["opt"]
    step_s, tps, peak = r["step_s"], r["tps"], r["peak"]
    share = tps * cfg.flops_per_token(seq) / BF16_FLOPS
    print(f"  train: {tps:.1f} tokens/s ({step_s * 1e3:.1f} ms per step of "
          f"{batch} x {seq} tokens, {cfg.flops_per_token(seq) / 1e9:.3f} "
          f"GFLOP/token), {share:.2%} of the dense bf16 peak; peak memory "
          f"{peak / 2**30:.2f} GiB")

    modes = remat_modes(cfg, state.params, data)
    state, prof = profile_train(step, state, data, step_s)
    ce_ms, opt_ms = time_ce_and_optimizer(cfg, opt, state, batch, seq)
    # The same weights through the kernels and through the plain dense
    # attention, at batch 2 (the dense path keeps [B, H, S, S] scores).
    grad_err = grad_step_checks(cfg, state.params, data["tokens"][:2])
    return {"cfg": cfg, "f1_launches": r["launches"][0],
            "f2_launches": r["launches"][1], "tokens_per_s": tps,
            "peak_share": share, "step_ms": step_s * 1e3,
            "peak_gib": peak / 2**30,
            "losses": r["losses"], "profile": prof, "ce_ms": ce_ms,
            "opt_ms": opt_ms, "grad_err": grad_err, "modes": modes}


# Flash forward launches per layer in one forward + backward of each remat
# mode (models/llama.py): the modes that keep the flash outputs never
# replay the forward kernel.
F1_PER_LAYER = {"none": 1, "full": 2, "attn": 2, "flash": 1, "dots": 2,
                "flash_qkv": 1, "flash_qkv_ffn": 1, "flash_qkv_ffn8": 1}


def remat_modes(cfg, params, data,
                modes=("flash_qkv", "full", "attn", "flash", "dots",
                       "flash_qkv_ffn", "flash_qkv_ffn8", "none")):
    """Forward + backward (``grad_step``, no optimizer update) of each
    remat mode on the same weights and batch, twice: the second call is
    timed (wall, ending in a sync), the peak memory is that of both, and
    each call must launch F1_PER_LAYER forwards and one backward per
    layer. Every exact mode's loss equals flash_qkv's to 1e-3 relative (the
    same forward operations; bf16 noise); flash_qkv_ffn8's within 2%, the
    reference's bound for its int8 activations (tests/test_model.py)."""
    from ray_tpu_torch.ops.flash_attention import make_flash_attention
    from ray_tpu_torch.train.step import global_norm, grad_step

    n = cfg.n_layers
    out = {}
    for mode in modes:
        fn = grad_step(dataclasses.replace(cfg, remat=mode),
                       make_flash_attention())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):  # the first call warms the allocator's cache
            reset_counts()
            t0 = time.perf_counter()
            m, grads = fn(params, data)
            sync()
            dt = time.perf_counter() - t0
            _, f1, f2 = counts()
            check(f1 == F1_PER_LAYER[mode] * n and f2 == n,
                  f"remat {mode}: {f1} forward and {f2} backward flash "
                  f"launches for {n} layers, expected "
                  f"{F1_PER_LAYER[mode] * n} and {n}")
            loss, norm = float(m["loss"]), float(global_norm(grads))
            del grads
        peak = torch.cuda.max_memory_allocated()
        out[mode] = dict(ms=dt * 1e3, peak=peak, peak_gib=peak / 2**30, f1=f1,
                         f2=f2, loss=loss, grad_norm=norm,
                         slack=torch.cuda.max_memory_reserved() - peak)
        base = out["flash_qkv"]
        rel = abs(loss - base["loss"]) / base["loss"]
        limit = 2e-2 if mode == "flash_qkv_ffn8" else 1e-3
        print(f"  remat {mode}: forward + backward {dt * 1e3:.1f} ms, peak "
              f"memory {peak / 2**30:.2f} GiB, flash launches {f1} + {f2}, "
              f"loss {loss:.5f} ({rel:.2e} from flash_qkv, limit {limit}),"
              f" grad_norm {norm:.4f}")
        check(math.isfinite(loss) and rel <= limit,
              f"remat {mode}: loss {loss} against flash_qkv's "
              f"{base['loss']}")
    return out


def moe_flops_per_token(cfg, seq):
    """Training FLOPs per token of the MoE model as the dense count does
    it (6 x matmul parameters + the attention term), counting the router
    and the top_k experts a token reaches (the active parameters)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * d * hq + 2 * d * hkv + d * cfg.num_experts \
        + cfg.top_k * 3 * d * f
    return 6.0 * (L * per_layer + v * d) + 12 * L * d * seq


def moe_oracle_check(cfg, params, device="cuda"):
    """The reference's oracle on the card (tests/test_moe.py): with
    capacity for every token, moe_ffn in fp32 equals the gate-weighted sum
    of each chosen expert's dense SwiGLU FFN, here for layer 0 of the
    moe_bench weights on 64 tokens, at the reference's 2e-3."""
    from ray_tpu_torch.models.moe import moe_ffn

    c = dataclasses.replace(cfg, dtype=torch.float32, capacity_factor=8.0)
    layer = {k: v[0].detach().float() for k, v in params["blocks"].items()}
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((1, 64, c.d_model), generator=g, device=device)
    with torch.no_grad():
        out, _ = moe_ffn(x, layer, c)
        tokens = x[0]
        probs = torch.softmax(tokens @ layer["router"], -1)
        gv, gi = probs.topk(c.top_k, -1)
        gv = gv / gv.sum(-1, keepdim=True)
        want = torch.zeros_like(tokens)
        for t in range(tokens.shape[0]):
            for j in range(c.top_k):
                e, h = int(gi[t, j]), tokens[t]
                act = torch.nn.functional.silu(h @ layer["w_gate"][e]) * (
                    h @ layer["w_up"][e])
                want[t] += gv[t, j] * (act @ layer["w_down"][e])
    compare("moe_ffn fp32 vs the dense top-k ensemble (capacity ample)",
            out[0], want, 2e-3, 2e-3)


def phase5(seed, device="cuda", batch=16, seq=2048, warmup=2, steps=4):
    """MoE training: moe_bench at full width and depth through F1 and F2 at
    head_dim 64."""
    from ray_tpu_torch.models.moe import MOE_PRESETS

    print("phase 5: MoE training, moe_bench preset")
    cfg = dataclasses.replace(MOE_PRESETS["moe_bench"], attn_impl="flash")
    n = cfg.n_layers
    r = train_run(cfg, seed, device, batch, seq, warmup, steps, 2 * n, n,
                  f"MoE remat {cfg.remat}")
    losses, aux = r["losses"], r["aux"]
    check(losses[-1] < losses[0],
          f"MoE loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(len(aux) == len(losses) and min(aux) > 0,
          f"MoE aux loss not positive: {aux}")
    share = r["tps"] * moe_flops_per_token(cfg, seq) / BF16_FLOPS
    print(f"  MoE train: {r['tps']:.1f} tokens/s ({r['step_s'] * 1e3:.1f} ms "
          f"per step of {batch} x {seq} tokens), {share:.2%} of the dense "
          f"bf16 peak at {moe_flops_per_token(cfg, seq) / 1e9:.3f} active "
          f"GFLOP/token; peak memory {r['peak'] / 2**30:.2f} GiB; flash "
          f"launches {r['launches'][0]} + {r['launches'][1]}")
    state, prof = profile_train(r["step"], r["state"], r["data"],
                                r["step_s"])
    moe_oracle_check(cfg, state.params, device)
    return {"cfg": cfg, "f1_launches": r["launches"][0],
            "f2_launches": r["launches"][1], "tokens_per_s": r["tps"],
            "step_ms": r["step_s"] * 1e3, "peak_gib": r["peak"] / 2**30,
            "losses": losses, "aux": aux, "profile": prof,
            "peak_share": share}


def phase6(seed, device="cuda", n_layers=4, batch=2, seq=4096, warmup=2,
           steps=5):
    """The bench_8b.py recipe: 4 full llama3_8b layers (d 4096, 32/8 heads,
    d_ff 14336), vocab 8192, flash attention, remat "full", batch 2 x
    4096 tokens, AdamW with a bf16 first moment."""
    from ray_tpu_torch.train.memory import bench8b_config

    print("phase 6: the bench_8b.py recipe, 4 llama3_8b layers")
    cfg = bench8b_config(n_layers)
    r = train_run(cfg, seed, device, batch, seq, warmup, steps,
                  2 * n_layers, n_layers, "bench_8b")
    per_layer = r["step_s"] * 1e3 / n_layers
    print(f"  bench_8b: {r['tps']:.1f} tokens/s, {r['step_s'] * 1e3:.1f} ms "
          f"per step, {per_layer:.1f} ms per layer, peak memory "
          f"{r['peak'] / 2**30:.2f} GiB ({cfg.num_params() / 1e9:.3f} B "
          f"parameters)")
    return {"tokens_per_s": r["tps"], "per_layer_ms": per_layer,
            "peak": r["peak"], "peak_gib": r["peak"] / 2**30,
            "slack": r["slack"], "losses": r["losses"], "n_layers": n_layers,
            "batch": batch, "seq": seq}


def batch_to_device(batch, device):
    """A TokenDataset batch (host uint32) on the device: viewed as int32
    (ids are below 2^31; the step indexes with them and takes .long() of
    the targets), pinned, copied without blocking on the current
    stream."""
    t = torch.from_numpy(batch["tokens"].view(np.int32))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return {"tokens": t}


def loop_run(cfg, opt, state, ds, batch, device, start, stop):
    """Steps ``start`` .. ``stop`` - 1 of the training loop: batches from
    ``ds`` (a fresh TokenDataset, so its first epoch; a resumed loop skips
    the ``start`` batches it has trained on), each step ending in a sync.
    Returns the state, the losses and the wall time of each step, from
    asking for the batch to the sync."""
    from ray_tpu_torch.train import jit_train_step

    step = jit_train_step(cfg, opt)
    losses, wall = [], []
    batches = ds.iter_batches(batch)
    for i in range(stop):
        t0 = time.perf_counter()
        host = next(batches)
        if i < start:
            continue
        reset_counts()
        state, m = step(state, batch_to_device(host, device))
        sync()
        wall.append(time.perf_counter() - t0)
        _, n1, n2 = counts()
        check(n1 == n2 == cfg.n_layers,
              f"loop step {i}: {n1} + {n2} flash launches")
        losses.append(float(m["loss"]))
    batches.close()
    return state, losses, wall


def phase7(seed, device="cuda", batch=16, seq=2048, steps=6, save_at=3,
           cfg=None):
    """The single-device training loop on the bench preset at full width
    and depth (24 layers, remat flash_qkv): a token file written from the
    seed, read through TokenDataset (shuffled, prefetched, the ragged tail
    dropped), ``steps`` steps; then again with a CheckpointManager save at
    step ``save_at``, a restore into a fresh state (bit for bit the saved
    one) and the steps after it. The resumed losses must equal the
    uninterrupted ones within one bf16 step (2^-8) relative, the bound
    phase 1 holds the bf16 F2's run-to-run dq spread to (its atomics make
    the card's trajectory not bit-reproducible; the CPU tests hold resume
    bit for bit)."""
    import os
    import tempfile

    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train import (
        CheckpointManager,
        TokenDataset,
        init_train_state,
        make_optimizer,
        train_state_dict,
    )

    print("phase 7: training loop, bench preset (token file, TokenDataset, "
          "checkpoint, resume)")
    cfg = cfg or dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    opt = make_optimizer(lr=3e-4, warmup=1, total_steps=steps,
                         mu_dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "tokens.bin")
        windows = steps * batch + batch // 2  # a ragged tail
        np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=windows * (seq + 1) + 7, dtype=np.uint32
        ).tofile(path)
        corpus = np.fromfile(path, dtype=np.uint32)

        def dataset():
            return TokenDataset(path, seq, seed=seed)

        ds = dataset()
        check(ds.num_samples == windows, f"{ds.num_samples} windows")
        epoch = [b["tokens"] for b in ds.iter_batches(batch)]
        ds.close()
        check(len(epoch) == steps, f"{len(epoch)} batches, the tail kept")
        # Every row is a distinct window of the file, not in file order.
        index = {w.tobytes(): i for i, w in enumerate(
            corpus[: windows * (seq + 1)].reshape(windows, seq + 1))}
        order = [index.get(row.tobytes(), -1)
                 for e in epoch for row in e]
        check(min(order) >= 0 and len(set(order)) == len(order)
              and order != sorted(order),
              "the batches are not distinct shuffled windows of the file")

        # The uninterrupted run.
        torch.cuda.reset_peak_memory_stats()
        ds = dataset()
        state = init_train_state(cfg, opt, seed=seed, device=device)
        state, want, wall = loop_run(cfg, opt, state, ds, batch, device, 0,
                                     steps)
        ds.close()
        peak = torch.cuda.max_memory_allocated()
        tps = batch * seq * (steps - 1) / sum(wall[1:])
        whole = train_state_dict(state)
        del state
        gc.collect()

        # Train to save_at, save, restore into a fresh state, train on.
        ds = dataset()
        state = init_train_state(cfg, opt, seed=seed, device=device)
        state, got, _ = loop_run(cfg, opt, state, ds, batch, device, 0,
                                 save_at)
        ds.close()
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), num_to_keep=2)
        sync()
        t0 = time.perf_counter()
        ck_path = mgr.save(state.step, state, metrics={"loss": got[-1]})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in os.scandir(ck_path))
        fresh = init_train_state(cfg, opt, seed=seed + 1, device=device)
        sync()
        t0 = time.perf_counter()
        where, restored = mgr.restore_latest_valid(target=fresh)
        sync()
        restore_s = time.perf_counter() - t0
        check(where == ck_path and restored.step == save_at
              and restored.opt_state.count == save_at,
              f"restored {where} at step {restored.step}")
        saved, back = train_state_dict(state), train_state_dict(restored)
        check(saved.keys() == back.keys() and all(
            back[k].dtype == saved[k].dtype
            and back[k].device == saved[k].device
            and torch.equal(back[k], saved[k]) for k in saved),
            "the restored state differs from the saved one")
        del state, fresh, saved, back
        gc.collect()
        ds = dataset()
        restored, rest, _ = loop_run(cfg, opt, restored, ds, batch, device,
                                     save_at, steps)
        ds.close()
        check(restored.step == steps, f"resumed run ended at {restored.step}")
        # The two runs' parameters and moments after the last step, each
        # kind as one vector (they differ by the bf16 F2's run-to-run
        # spread only).
        ended = train_state_dict(restored)
        drift = {}
        for kind in ("params", "mu", "nu"):
            keys = [k for k in whole if k.startswith(kind + "/")]
            diff = sum(float((ended[k].float() - whole[k].float()).square()
                             .sum()) for k in keys)
            norm = sum(float(whole[k].float().square().sum()) for k in keys)
            drift[kind] = math.sqrt(diff / norm)
        del restored, ended, whole
    got += rest
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print("  losses, uninterrupted: " + ", ".join(f"{x:.6f}" for x in want))
    print("  losses, resumed at step "
          f"{save_at}: " + ", ".join(f"{x:.6f}" for x in got)
          + f"; largest relative difference {max(rel):.3e} (before the "
          f"save {max(rel[:save_at]):.3e}; limit 2^-8)")
    print(f"  state after step {steps}, resumed vs uninterrupted, relative "
          f"difference: " + ", ".join(f"{k} {v:.3e}"
                                      for k, v in drift.items()))
    check(all(math.isfinite(x) for x in want + got)
          and abs(want[0] - math.log(cfg.vocab_size)) < 0.5,
          f"loop losses {want} (step 0 not within 0.5 of ln V)")
    check(all(r <= 2**-8 for r in rel),
          "the resumed loss trajectory leaves the uninterrupted one")
    print(f"  checkpoint of the bench state: {nbytes / 1e9:.3f} GB, save "
          f"{save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s), restore "
          f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s)")
    print(f"  loop: {tps:.1f} tokens/s through TokenDataset ({batch} x "
          f"{seq} tokens a step, steps 1-{steps - 1}), peak memory "
          f"{peak / 2**30:.2f} GiB")
    return {"cfg": cfg, "tokens_per_s": tps, "save_s": save_s,
            "restore_s": restore_s, "ckpt_bytes": nbytes, "peak": peak,
            "losses": want, "resumed": got, "max_rel": max(rel),
            "drift": drift}


def planner_checks(p4, p6, p7, batch=16, seq=2048):
    """train/memory.py's plan beside each peak it prices, measured in this
    run: the bench preset under remat full, dots and none (phase 4, one
    forward + backward with the train state resident), the bench_8b.py
    recipe (phase 6, whole steps). Each prediction must be within 15% of
    torch.cuda.max_memory_allocated, and each must fit the card, since
    each ran. Prints the working-set factor this run implies for each (the
    fit PERF.md keeps), the memory outside the caching allocator and the
    allocator's own slack, and the loop's flash_qkv peak (priced as
    "none", the reference's rule) for information."""
    from ray_tpu_torch.train import memory

    def implied(plan, cfg, measured, per_layer):
        unit = plan.batch * plan.seq * cfg.d_ff * cfg.dtype.itemsize
        boundary = cfg.n_layers * plan.batch * plan.seq * cfg.d_model \
            * cfg.dtype.itemsize
        fixed = plan.total_bytes - plan.activation_bytes + boundary
        return (measured - fixed) / (unit * (cfg.n_layers if per_layer
                                             else 1))

    cases = []
    for mode in ("full", "dots", "none"):
        cfg = dataclasses.replace(p4["cfg"], remat=mode)
        run = p4["modes"][mode]
        cases.append((f"bench remat {mode}", cfg,
                      memory.plan(cfg, batch, seq), run["peak"],
                      run["slack"], mode != "full"))
    cfg8 = memory.bench8b_config(p6["n_layers"])
    cases.append(("bench_8b recipe", cfg8,
                  memory.plan_bench8b(p6["n_layers"], p6["batch"],
                                      p6["seq"]), p6["peak"], p6["slack"],
                  False))
    out = {}
    for label, cfg, plan, measured, slack, per_layer in cases:
        err = plan.total_bytes / measured - 1
        factor = implied(plan, cfg, measured, per_layer)
        print(f"  planner {label}: predicted {plan.total_gb:.2f} GiB, "
              f"measured {measured / 2**30:.2f} GiB ({err:+.1%}); fits "
              f"{plan.fits} (usable {plan.usable_bytes / 2**30:.2f} GiB); "
              f"implied factor {factor:.3f}; allocator slack at the peak "
              f"{slack / 2**30:.3f} GiB")
        check(abs(err) <= 0.15 and plan.fits,
              f"planner {label}: {plan.total_gb:.2f} GiB against "
              f"{measured / 2**30:.2f} GiB measured, fits {plan.fits}")
        out[label] = dict(pred_gib=plan.total_gb, peak_gib=measured / 2**30,
                          err=err, factor=factor, slack=slack)
    loop = memory.plan(p7["cfg"], batch, seq)
    print(f"  planner training loop (remat flash_qkv, priced as none): "
          f"predicted {loop.total_gb:.2f} GiB, measured "
          f"{p7['peak'] / 2**30:.2f} GiB")
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    slack = max(v["slack"] for v in out.values())
    print(f"  card {total / 2**30:.2f} GiB: {outside / 2**30:.3f} GiB outside "
          f"the caching allocator (context, libraries) + largest allocator "
          f"slack at a priced peak {slack / 2**30:.3f} GiB = "
          f"{(outside + slack) / 2**30:.3f} GiB; reserve priced "
          f"{memory.ALLOCATOR_RESERVE_BYTES / 2**30:.3f} GiB")
    return out

# ------------------------------------------------------------ phase 8
# The local head layouts (query heads, KV heads, head_dim) a tp rank hands
# the kernels, with the (B, S) of the flash calls: the bench preset at
# tp = 2 (phase 4's batch), llama3_8b at tp = 8 (the bench_8b.py recipe's
# B=2 S=4096), moe_bench at tp = 2; P1 at llama3_8b tp = 2 and 8 and mini
# tp = 4 (phase 2's first decode step). Only the first flash layout and
# the first paged one run on phase 8b's main path (two ranks on one card).
TP_FLASH = (("bench tp=2", (4, 2, 128), (16, 2048), "_tp2"),
            ("llama3_8b tp=8", (4, 1, 128), (2, 4096), "_8b_tp8"),
            ("moe_bench tp=2", (8, 4, 64), (16, 2048), "_d64_tp2"))
TP_PAGED = (("llama3_8b tp=2", (16, 4, 128), "_tp2"),
            ("llama3_8b tp=8", (4, 1, 128), "_tp8"),
            ("mini tp=4", (3, 1, 64), "_mini_tp4"))
# Two ranks on one card over gloo: the losses and gradient norms of the
# sharded bench steps against the same steps in one process on the same
# weights and batch, both with no learning-rate warm-up, so that step 1's
# loss is taken after a full-rate AdamW update of the sharded state. They
# differ by bf16 rounding only: fsdp's ranks run products of half the rows
# (other cuBLAS tiles), tp's ranks sum bf16 partial products over the
# ranks where one product summed them in fp32. Sound runs read at most
# 1.8e-5 (loss) and 7.2e-4 (gradient norm), both at tp's step 1; a planted
# fault at least 3.8e-4 (loss: fsdp's gradient reduce-scatter left out, at
# step 1 only) and 0.26 or NaN (gradient norm; the tp sum of activations
# or of gradients left out) (sharded_chip.py train-faults; PERF.md PR 7).
TWO_RANK_LOSS_REL = 1e-4
TWO_RANK_NORM_REL = 2e-3
# The rows of phase 8a whose shapes phase 8b's main path runs (and whose
# launches it counts): the kernels line carries them.
TP_MAIN_ROWS = ("paged_attention_tp2", "flash_fwd_train_tp2",
                "flash_bwd_tp2")


def heads_cfg(heads, dtype=torch.bfloat16):
    """What the timing functions read of a config, at one head layout."""
    h, hkv, dh = heads
    return types.SimpleNamespace(n_heads=h, n_kv_heads=hkv, head_dim=dh,
                                 dtype=dtype)


def phase8a(positions):
    """F1/F2 and P1 at the local shapes of a tp rank, against their plain
    versions in fp32 on the same bf16 inputs (bf16, the main paths' type;
    ``FLASH_ORACLE_TOL``, ``PAGED_ORACLE_TOL``), then timed like the
    full-width rows."""
    print("phase 8a: the kernels at a tp rank's local shapes")
    rows = {}
    for label, heads, (b, s), tag in TP_FLASH:
        print(f"  {label}: heads {heads[0]}/{heads[1]} of {heads[2]}, "
              f"B={b} S={s}")
        errs = flash_bwd_checks({torch.bfloat16: FLASH_BF16_TOL},
                                heads=heads, shapes=((b, s),),
                                dtypes=(torch.bfloat16,), train=(b, s),
                                tag=tag, oracle=True)
        rows.update(timing_training(heads_cfg(heads), errs, batch=b, seq=s,
                                    tag=tag))
    for label, heads, tag in TP_PAGED:
        print(f"  {label}: heads {heads[0]}/{heads[1]} of {heads[2]}")
        err = paged_checks(heads=heads, oracle=True)
        rows["paged_attention" + tag] = paged_row(
            heads_cfg(heads), positions, err, "paged_attention" + tag)
    return rows


def rank_serve(seed, tp):
    """One rank of llama3_8b served with mesh {"tp": tp}: phase 2's
    prompts, paged, 32 greedy tokens."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import PRESETS, init_params
    from ray_tpu_torch.parallel.mesh import make_mesh

    cfg = PRESETS["llama3_8b"]
    mesh = make_mesh({"tp": tp})
    params = init_params(cfg, seed, device="cuda", dtype=cfg.dtype)
    eng = LLMEngine(cfg, max_batch=8, max_seq=2048, params=params, mesh=mesh,
                    kv="paged", page_size=64, seed=seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prompts = serving_prompts(cfg, np.random.default_rng(seed))
    serve(eng, prompts, SamplingParams(max_tokens=2))  # warm-up
    steps0 = eng.stats()["decode_steps"]
    reset_counts()
    outs, step_s, step_tokens, _ = serve(eng, prompts,
                                         SamplingParams(max_tokens=32))
    launches = counts()[0]
    out = dict(outs=outs, launches=launches,
               decode_steps=eng.stats()["decode_steps"] - steps0,
               kv_heads=eng.cache["k"].shape[2],
               decode_tps=sum(step_tokens[1:]) / sum(step_s[1:]),
               peak=torch.cuda.max_memory_allocated())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_train(seed, sizes, batch=16, seq=2048, steps=2, cfg=None):
    """One rank of the first ``steps`` train steps of ``cfg`` (by default
    the bench preset with flash attention) under mesh ``sizes`` (axis
    sizes for make_mesh, or a function that builds the mesh; None: one
    process, no mesh): phase 4's weights (from the seed) and batch (the
    whole batch; the step cuts it over the data axes), phase 4's
    optimizer with no warm-up (the first update at the full learning
    rate)."""
    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train.step import (
        init_train_state,
        jit_train_step,
        make_optimizer,
    )

    if cfg is None:
        cfg = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    mesh = (sizes() if callable(sizes)
            else make_mesh(sizes) if sizes else None)
    opt = make_optimizer(warmup=0, total_steps=1000,
                         mu_dtype=torch.bfloat16)
    state = init_train_state(cfg, opt, seed=seed, device="cuda", mesh=mesh)
    step = jit_train_step(cfg, opt, mesh)
    rng = np.random.default_rng(seed)
    data = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))).to("cuda")}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, aux, wall = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync()
        wall.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "aux_loss" in m:
            aux.append(float(m["aux_loss"]))
    _, f1, f2 = counts()
    out = dict(losses=losses, norms=norms, aux=aux, wall=wall, f1=f1, f2=f2,
               peak=torch.cuda.max_memory_allocated())
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Meshes of phase 8b's training runs, two ranks each.
TWO_RANK_MESHES = {"fsdp=2": {"fsdp": 2}, "tp=2": {"tp": 2}}


def _serve_and_train(seed):
    """Phase 8b's work on one rank: llama3_8b served with mesh {"tp": 2},
    then the bench steps under each of ``TWO_RANK_MESHES``."""
    out = {"serve": rank_serve(seed, 2)}
    out.update({name: rank_train(seed, sizes)
                for name, sizes in TWO_RANK_MESHES.items()})
    return out


def _rank_main(rank, world, rdzv, results, work, args):
    """A spawned rank: its GPU is cuda:0, shared with the other rank; gloo
    carries the collectives (copying CUDA tensors through host memory).
    Puts (rank, True, ``work(*args)``) or (rank, False, the traceback) on
    ``results``."""
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=rdzv, world_size=world,
                                rank=rank)
        torch.cuda.set_device(0)
        results.put((rank, True, work(*args)))
    except BaseException:  # the parent fails the phase with this text
        import traceback

        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_two_ranks(work, args, timeout=600):
    """Spawn two ranks running ``work(*args)`` (a module-level function),
    wait for both results (at most ``timeout`` seconds), kill whatever is
    left, raise on any failure."""
    import multiprocessing as mp
    import os
    import queue
    import tempfile

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rdzv_") as tmp:
        rdzv = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, 2, rdzv, results, work, args))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = {}
        try:
            while len(out) < 2:
                try:
                    rank, ok, payload = results.get(
                        timeout=max(deadline - time.monotonic(), 1.0))
                except queue.Empty:
                    raise SmokeFailure(f"{2 - len(out)} of two ranks gave "
                                       f"no result in {timeout} s")
                check(ok, f"rank {rank} of two failed:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[0], out[1]]


def phase8b(seed, p4, p2_outs):
    """Two ranks on the one card over gloo (correctness only: their times
    include host copies of every collective): llama3_8b at full width and
    depth served with mesh {"tp": 2}, then the bench preset's first two
    steps under {"fsdp": 2} and {"tp": 2}."""
    from ray_tpu_torch.models.llama import PRESETS, init_params
    from ray_tpu_torch.train import memory

    print("phase 8b: two ranks on one card over gloo (correctness only)")
    single = rank_train(seed, None)
    print(f"  bench in one process, no warm-up: losses {single['losses']}, "
          f"grad_norms {single['norms']}")
    t0 = time.time()
    ranks = run_two_ranks(_serve_and_train, (seed,))
    print(f"  two ranks ran in {time.time() - t0:.1f} s")
    cfg = PRESETS["llama3_8b"]
    sv = [r["serve"] for r in ranks]
    check(sv[0]["outs"] == sv[1]["outs"], "the tp ranks emitted different "
          "streams")
    check(all(len(o) == 32 for o in sv[0]["outs"]),
          "a tp request did not finish with 32 tokens")
    for r in sv:
        check(r["kv_heads"] == cfg.n_kv_heads // 2,
              f"a tp rank's pool holds {r['kv_heads']} KV heads")
        check(r["launches"] == cfg.n_layers * r["decode_steps"],
              f"a tp rank launched P1 {r['launches']} times for "
              f"{r['decode_steps']} decode steps x {cfg.n_layers} layers")
    print(f"  serving llama3_8b tp=2: {sv[0]['decode_steps']} decode steps, "
          f"P1 launches {sv[0]['launches']} + {sv[1]['launches']}, "
          f"{sv[0]['kv_heads']} KV heads per rank, decode "
          f"{sv[0]['decode_tps']:.1f} tokens/s (gloo), peak "
          f"{sv[0]['peak'] / 2**30:.2f} / {sv[1]['peak'] / 2**30:.2f} GiB "
          f"per rank")
    params = init_params(cfg, seed, device="cuda", dtype=cfg.dtype)
    prompts = serving_prompts(cfg, np.random.default_rng(seed))
    stream_check(cfg, params, prompts, sv[0]["outs"], "tp=2 greedy")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"single": single["losses"], "single_norms": single["norms"],
           "serve_launches": sv[0]["launches"] + sv[1]["launches"],
           "same_streams": sum(a == b for a, b in zip(sv[0]["outs"],
                                                       p2_outs))}
    print(f"  tp=2 streams equal to phase 2's single-process streams: "
          f"{out['same_streams']} of {len(prompts)}")
    bench = p4["cfg"]
    for name in TWO_RANK_MESHES:
        tr = [r[name] for r in ranks]
        check(tr[0]["losses"] == tr[1]["losses"]
              and tr[0]["norms"] == tr[1]["norms"],
              f"{name}: the ranks report different losses")
        for i, (loss, norm) in enumerate(zip(tr[0]["losses"],
                                             tr[0]["norms"])):
            want, want_norm = single["losses"][i], single["norms"][i]
            rel, rel_norm = abs(loss / want - 1), abs(norm / want_norm - 1)
            print(f"  bench {name} step {i}: loss {loss:.6f} (single "
                  f"process {want:.6f}, rel {rel:.2e}), grad_norm "
                  f"{norm:.6f} ({want_norm:.6f}, rel {rel_norm:.2e}), "
                  f"{tr[0]['wall'][i]:.2f} s (gloo)")
            check(rel <= TWO_RANK_LOSS_REL and rel_norm <= TWO_RANK_NORM_REL,
                  f"{name} step {i}: loss or gradient norm off the single "
                  f"process's by more than {TWO_RANK_LOSS_REL} / "
                  f"{TWO_RANK_NORM_REL}")
        n = bench.n_layers * 2
        for r in tr:
            check(r["f1"] == n and r["f2"] == n,
                  f"{name}: a rank launched F1 {r['f1']} and F2 {r['f2']} "
                  f"times, expected {n} each")
        per_rank_batch = 16 // TWO_RANK_MESHES[name].get("fsdp", 1)
        plan = memory.plan(bench, per_rank_batch, 2048,
                           fsdp=TWO_RANK_MESHES[name].get("fsdp", 1))
        print(f"  bench {name}: F1 {tr[0]['f1']} + {tr[1]['f1']}, F2 "
              f"{tr[0]['f2']} + {tr[1]['f2']} launches; per-rank peak "
              f"{tr[0]['peak'] / 2**30:.2f} / {tr[1]['peak'] / 2**30:.2f} "
              f"GiB beside plan_memory(batch {per_rank_batch}, fsdp "
              f"{TWO_RANK_MESHES[name].get('fsdp', 1)}) "
              f"{plan.total_gb:.2f} GiB (remat flash_qkv priced as none)")
        out[name] = dict(f1=tr[0]["f1"] + tr[1]["f1"],
                         f2=tr[0]["f2"] + tr[1]["f2"],
                         peaks=[r["peak"] for r in tr], plan=plan.total_gb,
                         losses=tr[0]["losses"], norms=tr[0]["norms"])
    return out


# ------------------------------------------------------------ phase 9
# Pipeline parallelism (9a): the bench preset's 24 layers as 2 stages of
# 12 over pp = 2, GPipe with 4 microbatches of phase 4's 16 x 2048 batch.
PIPE_STAGES, PIPE_MICRO = 2, 4
# The flash kernels at the pipeline's microbatch shape (B = 16 / 4): the
# kernels line's rows "flash_fwd_train_pp" and "flash_bwd_pp".
PIPE_SHAPE = (16 // PIPE_MICRO, 2048)
# 9c, remat "flash_qkv_ffn8" under tp = 2, against one process under the
# same mode: the loss and gradient norm within phase 8b's limits (sound
# runs read loss 1.6e-5 to 2.5e-5, gradient norms at most 6.3e-4; PERF.md
# PR 8). Leaving the tp max of the int8 scale out moves neither beyond
# them (loss 2.7e-5, gradient norm 9.5e-4: each rank quantizes its columns
# more finely), so every int8 value and scale the step's kept op makes is
# held exactly to the whole rows' quantization, on every
# INT8_ROW_STRIDE-th row of each activation (256 of bench's 32768).
INT8_ROW_STRIDE = 128
# moe_bench (9d) against one process. Step 0 reads the same loss and aux
# bits; after one full-rate update, routing near-ties that the two runs'
# bf16 roundings (and F2's atomics) move flip: step 1 read loss 6.1e-5 to
# 9.1e-5 relative, aux 2.5e-3 to 2.7e-3, gradient norm up to 1.1e-3
# (three chip runs). Routing in per-rank groups where the groups span sp
# read loss 1.7e-4 / 1.5e-3, aux 6.9e-2 / 1.0e-1 and gradient norms
# 9.0e-3 / 3.0e-2 (steps 0 / 1; sharded_chip.py train-faults;
# PERF.md).
MOE_LOSS_REL = 1e-3
MOE_AUX_REL = 1e-2
MOE_NORM_REL = 5e-3


def _multislice_fsdp2():
    """9e's mesh: {"fsdp": 2} across two fake slices of one rank each."""
    from ray_tpu_torch.parallel.mesh import (
        fake_slice_devices,
        make_multislice_mesh,
    )

    return make_multislice_mesh({}, {"fsdp": 2},
                                ranks=fake_slice_devices(2))


def phase9_runs():
    """Phase 9's two-rank training runs: name -> (config, mesh sizes or a
    function that builds the mesh). 9b the bench preset with flash
    attention under sp = 2 (the sequence gathered for F1/F2); 9c the
    bench preset under remat
    "flash_qkv_ffn8" with tp = 2; 9d moe_bench (flash) under sp = 2 with
    routing groups of 2048 tokens, one whole sequence, so that every group
    spans both sp ranks (moe_bench's own 1024-token groups would lie in
    one rank's block, the path phase 5 runs); 9e phase 8b's fsdp = 2 run
    on a multislice mesh of two one-rank fake slices."""
    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.models.moe import MOE_PRESETS

    bench = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    moe = dataclasses.replace(MOE_PRESETS["moe_bench"], attn_impl="flash",
                              group_size=2048)
    return {
        "sp=2": (bench, {"sp": 2}),
        "tp=2 ffn8": (dataclasses.replace(bench, remat="flash_qkv_ffn8"),
                      {"tp": 2}),
        "moe sp=2": (moe, {"sp": 2}),
        "multislice fsdp=2": (bench, _multislice_fsdp2),
    }


def _pipeline_inputs(seed):
    """The bench preset (flash, remat "flash_qkv"), its fp32 weights and
    phase 4's batch, from the seed."""
    from ray_tpu_torch.models.llama import PRESETS, init_params

    cfg = dataclasses.replace(PRESETS["bench"], attn_impl="flash")
    params = init_params(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (16, 2048 + 1))).to("cuda")
    return cfg, params, tokens


def _pipeline_pieces(cfg, params, tokens):
    """(embedded inputs, targets, stage_fn, loss_head) of 9a: the
    embedding before the pipeline, a stage's layers through the port's
    layer loop (flash attention, remat "flash_qkv"), the final norm and
    the chunked cross entropy as the replicated loss head."""
    from ray_tpu_torch.models.llama import apply_blocks, embed
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.norms import rms_norm
    from ray_tpu_torch.ops.rope import rope_frequencies
    from ray_tpu_torch.train.step import chunked_cross_entropy

    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    cos, sin = rope_frequencies(cfg.head_dim, inputs.shape[1],
                                cfg.rope_theta, device=tokens.device)

    def stage_fn(p, x):
        return apply_blocks(x, p, cos, sin, cfg, flash_attention)[0]

    def loss_head(y, batch):
        return chunked_cross_entropy(rms_norm(y, params["final_norm"]),
                                     params["lm_head"], batch["targets"],
                                     cfg.dtype)

    return embed(params, inputs, cfg), targets, stage_fn, loss_head


def pipeline_single(seed):
    """9a's reference: the same 24 blocks applied in order in one process
    on the whole batch; the loss and each parameter's gradient norm."""
    cfg, params, tokens = _pipeline_inputs(seed)
    leaves = _leaf_dict(params)
    for t in leaves.values():
        t.requires_grad_(True)
    reset_counts()
    t0 = time.perf_counter()
    x, targets, stage_fn, loss_head = _pipeline_pieces(cfg, params, tokens)
    loss = loss_head(stage_fn(params["blocks"], x), {"targets": targets})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    sync()
    wall = time.perf_counter() - t0
    _, f1, f2 = counts()
    norms = {k: float(g.float().norm()) for k, g in zip(leaves, grads)}
    out = dict(loss=loss.item(), norms=norms, f1=f1, f2=f2, wall=wall)
    del params, leaves, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaf_dict(params):
    return {"tok_emb": params["tok_emb"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            **{"blocks/" + k: v for k, v in params["blocks"].items()}}


def rank_pipeline(seed):
    """One rank of 9a: ``pipeline_loss_fn`` over mesh {"pp": 2} with 4
    microbatches; the rank holds its stage's 12 layers (DTensors placed
    over pp, stacked [2, 12, ...]) and the embedding, final norm and
    lm_head whole. Returns the loss, each parameter's gradient norm (a
    stage leaf's summed over pp), the flash launches and the wall time."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh, mesh_spec, pipeline_loss_fn
    from ray_tpu_torch.parallel.sharding import distribute, local

    cfg, params, tokens = _pipeline_inputs(seed)
    mesh = make_mesh({"pp": PIPE_STAGES})
    params["blocks"] = {
        k: distribute(v.reshape(PIPE_STAGES, -1, *v.shape[1:]), mesh,
                      mesh_spec("pp"))
        for k, v in params["blocks"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    leaves = _leaf_dict(params)
    for t in leaves.values():
        t.requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    x, targets, stage_fn, loss_head = _pipeline_pieces(cfg, params, tokens)
    loss = pipeline_loss_fn(params["blocks"],
                            {"inputs": x, "targets": targets}, stage_fn,
                            loss_head, mesh=mesh,
                            num_microbatches=PIPE_MICRO)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    sync()
    wall = time.perf_counter() - t0
    _, f1, f2 = counts()
    norms = {}
    for k, g in zip(leaves, grads):
        sq = local(g).float().square().sum()
        if k.startswith("blocks/"):
            dist.all_reduce(sq, group=mesh.get_group("pp"))
        norms[k] = float(sq.sqrt())
    out = dict(loss=loss.item(), norms=norms, f1=f1, f2=f2, wall=wall,
               peak=torch.cuda.max_memory_allocated())
    del params, leaves, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def int8_recorded():
    """Within: every quantization the int8 op of "flash_qkv_ffn8" makes
    (models/llama.py's ``_int8_ckpt_op``, through ``quantize_int8``)
    appends to the yielded list this rank's columns of every
    ``INT8_ROW_STRIDE``-th row of its activation, with their int8 values
    and scales as the op returned them."""
    from ray_tpu_torch.models import llama

    real, calls = llama.quantize_int8, []

    def record(x, mesh=None):
        q, scale = real(x, mesh)
        calls.append(tuple(t.reshape(-1, t.shape[-1])[::INT8_ROW_STRIDE]
                           .clone(memory_format=torch.contiguous_format)
                           for t in (x, q, scale)))
        return q, scale

    llama.quantize_int8 = record
    try:
        yield calls
    finally:
        llama.quantize_int8 = real


def int8_mismatches(calls):
    """How many recorded int8 values and scales differ from the whole
    rows' quantization: each recorded block gathered over the two ranks
    (mesh {"tp": 2}: rank r holds columns block r), quantized with no
    mesh, this rank's columns kept."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import quantize_int8

    rank, bad = dist.get_rank(), 0
    for x, q, scale in calls:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        want_q, want_scale = quantize_int8(torch.cat(parts, -1))
        bad += int((want_q.chunk(len(parts), -1)[rank] != q).sum()
                   + (want_scale != scale).sum())
    return bad


def rank_phase9(seed, name):
    """One rank of one phase 9 run: "pipeline" (9a) or a name of
    :func:`phase9_runs`; under "tp=2 ffn8" with the int8 op's
    quantizations of both steps held to the whole rows'
    (:func:`int8_mismatches`)."""
    if name == "pipeline":
        return rank_pipeline(seed)
    cfg, sizes = phase9_runs()[name]
    if name != "tp=2 ffn8":
        return rank_train(seed, sizes, cfg=cfg)
    with int8_recorded() as calls:
        out = rank_train(seed, sizes, cfg=cfg)
    out["int8"] = dict(calls=len(calls), bad=int8_mismatches(calls),
                       values=sum(q.numel() + s.numel() for _, q, s in calls))
    return out


def phase9_single(seed, name):
    """The one-process run a phase 9 run is held to."""
    if name == "pipeline":
        return pipeline_single(seed)
    cfg, _ = phase9_runs()[name]
    return rank_train(seed, None, cfg=cfg)


PHASE9_NAMES = ("pipeline", "sp=2", "tp=2 ffn8", "moe sp=2",
                "multislice fsdp=2")


def _phase9_work(seed):
    return {name: rank_phase9(seed, name) for name in PHASE9_NAMES}


def _rel(got, want):
    """|got / want - 1|, infinite for a NaN or an infinity."""
    return abs(got / want - 1) if math.isfinite(got) else math.inf


def phase9_readings(name, rank, single):
    """(text, ok): one rank's phase 9 run against its one-process run, at
    phase 9's limits. The pipeline: the loss within TWO_RANK_LOSS_REL and
    each parameter's gradient norm within TWO_RANK_NORM_REL; a training
    run: each step's loss (and MoE aux loss) within TWO_RANK_LOSS_REL
    (MOE_LOSS_REL for MoE, its aux loss within MOE_AUX_REL), each gradient
    norm within TWO_RANK_NORM_REL (MOE_NORM_REL for MoE); under
    "flash_qkv_ffn8" also the int8 op's quantizations: two per layer and
    step, no recorded value differing from the whole rows'."""
    if name == "pipeline":
        loss = _rel(rank["loss"], single["loss"])
        norms = {k: _rel(v, single["norms"][k])
                 for k, v in rank["norms"].items()}
        worst = max(norms, key=norms.get)
        return (f"loss {rank['loss']:.6f} (one process {single['loss']:.6f}"
                f", rel {loss:.2e}, limit {TWO_RANK_LOSS_REL}); gradient "
                f"norms rel at most {norms[worst]:.2e} ({worst}, limit "
                f"{TWO_RANK_NORM_REL})",
                loss <= TWO_RANK_LOSS_REL
                and norms[worst] <= TWO_RANK_NORM_REL)
    loss_limit = MOE_LOSS_REL if name == "moe sp=2" else TWO_RANK_LOSS_REL
    norm_limit = MOE_NORM_REL if name == "moe sp=2" else TWO_RANK_NORM_REL
    loss = [_rel(a, b) for a, b in zip(rank["losses"], single["losses"])]
    aux = [_rel(a, b) for a, b in zip(rank["aux"], single["aux"])]
    norm = [_rel(a, b) for a, b in zip(rank["norms"], single["norms"])]
    text = (f"losses {rank['losses']} (one process {single['losses']}, rel "
            + ", ".join(f"{x:.2e}" for x in loss) + f", limit {loss_limit})"
            + (f"; aux {rank['aux']} (rel "
               + ", ".join(f"{x:.2e}" for x in aux)
               + f", limit {MOE_AUX_REL})" if aux else "")
            + "; grad_norms rel " + ", ".join(f"{x:.2e}" for x in norm)
            + f" (limit {norm_limit})")
    ok = (max(loss) <= loss_limit and max(aux, default=0.0) <= MOE_AUX_REL
          and max(norm) <= norm_limit)
    if "int8" in rank:
        q8 = rank["int8"]
        want = 2 * phase9_runs()[name][0].n_layers * len(rank["losses"])
        text += (f"; int8 op: {q8['calls']} quantizations (expected "
                 f"{want}), {q8['bad']} of {q8['values']} recorded values "
                 f"and scales differ from the whole rows' (limit 0)")
        ok = ok and q8["calls"] == want and q8["bad"] == 0
    return text, ok


def phase9(seed, p8):
    """Two ranks on the one card over gloo (correctness only): (a) the
    bench preset pipelined over pp = 2, (b) under sp = 2 with flash, (c)
    under tp = 2 with remat "flash_qkv_ffn8", its int8 op held exact,
    (d) moe_bench under sp = 2 with groups spanning the ranks, (e) phase
    8b's fsdp = 2 run on a multislice mesh; each against one process."""
    print("phase 9: pipeline, sequence-gathered attention, int8 under tp, "
          "MoE under sp, multislice (two ranks over gloo, correctness "
          "only)")
    b, s = PIPE_SHAPE
    print(f"  the flash kernels at the pipeline's microbatch shape: B={b} "
          f"S={s}, heads {BENCH_HEADS[0]}/{BENCH_HEADS[1]} of "
          f"{BENCH_HEADS[2]}")
    errs = flash_bwd_checks({torch.bfloat16: FLASH_BF16_TOL},
                            heads=BENCH_HEADS, shapes=(PIPE_SHAPE,),
                            dtypes=(torch.bfloat16,), train=PIPE_SHAPE,
                            tag="_pp", oracle=True)
    rows = timing_training(heads_cfg(BENCH_HEADS), errs, batch=b, seq=s,
                           tag="_pp")
    single = {"sp=2": dict(losses=p8["single"], norms=p8["single_norms"],
                           aux=[])}
    for name in ("pipeline", "tp=2 ffn8", "moe sp=2"):
        t0 = time.time()
        single[name] = phase9_single(seed, name)
        print(f"  {name} in one process ({time.time() - t0:.1f} s): "
              + (f"loss {single[name]['loss']:.6f}, flash launches "
                 f"{single[name]['f1']} + {single[name]['f2']}"
                 if name == "pipeline" else
                 f"losses {single[name]['losses']}, grad_norms "
                 f"{single[name]['norms']}"))
    t0 = time.time()
    ranks = run_two_ranks(_phase9_work, (seed,))
    runs = phase9_runs()
    print(f"  two ranks ran in {time.time() - t0:.1f} s")
    out = {}
    pipe = [r["pipeline"] for r in ranks]
    n_steps = PIPE_MICRO + PIPE_STAGES - 1
    per_stage = runs["sp=2"][0].n_layers // PIPE_STAGES
    for i, r in enumerate(pipe):
        text, ok = phase9_readings("pipeline", r, single["pipeline"])
        print(f"  9a pipeline pp=2 M={PIPE_MICRO}, rank {i}: {text}; flash "
              f"launches {r['f1']} + {r['f2']}, {r['wall']:.2f} s (gloo), "
              f"peak {r['peak'] / 2**30:.2f} GiB")
        check(ok, f"9a: rank {i}'s pipelined loss or a gradient norm is off "
                  f"the one-process run's")
        # remat "flash_qkv" keeps the flash outputs: no forward replay.
        want = n_steps * per_stage
        check(r["f1"] == want and r["f2"] == want,
              f"9a: rank {i} launched F1 {r['f1']} and F2 {r['f2']} times, "
              f"expected (M + P - 1) x {per_stage} = {want} each")
    out["pipeline"] = dict(f1=sum(r["f1"] for r in pipe),
                           f2=sum(r["f2"] for r in pipe),
                           loss=pipe[0]["loss"], rows=rows)
    for name, (cfg, _) in runs.items():
        tr = [r[name] for r in ranks]
        check(tr[0]["losses"] == tr[1]["losses"]
              and tr[0]["norms"] == tr[1]["norms"],
              f"{name}: the ranks report different losses")
        want_single = (single[name] if name in single
                       else dict(losses=p8["fsdp=2"]["losses"],
                                 norms=p8["fsdp=2"]["norms"], aux=[]))
        if name == "multislice fsdp=2":
            # The same program on the same layout as phase 8b's flat
            # fsdp = 2: step 0 bit for bit; step 1 follows an update whose
            # dq F2 sums with atomics (not bit-reproducible run to run).
            check(tr[0]["losses"][0] == p8["fsdp=2"]["losses"][0],
                  f"9e: step 0 loss {tr[0]['losses'][0]!r} is not phase "
                  f"8b's flat fsdp=2 {p8['fsdp=2']['losses'][0]!r}")
        readings = [phase9_readings(name, r, want_single) for r in tr]
        print(f"  9{'bcde'[list(runs).index(name)]} {name}: "
              f"{readings[0][0]}; {tr[0]['wall'][0]:.2f} + "
              f"{tr[0]['wall'][1]:.2f} s (gloo), flash launches "
              f"{tr[0]['f1']} + {tr[0]['f2']} per rank")
        bad = [f"rank {i}: {text}" for i, (text, ok) in enumerate(readings)
               if not ok]
        check(not bad, f"{name}: off the one-process run's: {bad}")
        per_step = (F1_PER_LAYER[cfg.remat] * cfg.n_layers, cfg.n_layers)
        check(all(r["f1"] == 2 * per_step[0] and r["f2"] == 2 * per_step[1]
                  for r in tr),
              f"{name}: a rank launched F1 {tr[0]['f1']} / {tr[1]['f1']} and "
              f"F2 {tr[0]['f2']} / {tr[1]['f2']} times in two steps, "
              f"expected {2 * per_step[0]} and {2 * per_step[1]}")
        out[name] = dict(f1=tr[0]["f1"] + tr[1]["f1"],
                         f2=tr[0]["f2"] + tr[1]["f2"],
                         losses=tr[0]["losses"])
    return out


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


def time_paged(cfg, positions, kq, max_pages=32, page=64, seed=7):
    """P1 and its one-block plain version at one shape, L2 cold, with the
    bound of that shape's live pages and visible keys."""
    from ray_tpu_torch.ops.paged_attention import (
        kernel_split,
        paged_attention,
        paged_attention_reference,
    )

    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    args = paged_case(len(positions), kq, positions, max_pages, cfg.dtype,
                      seed=seed, n_heads=h, n_kv=hkv, head_dim=dh,
                      poison=False)
    ms = time_ms(lambda: paged_attention(*args))
    plain_ms = time_ms(lambda: paged_attention_reference(*args))
    # The host's share: the wrapper's checks, workspace lookup and launch,
    # 200 calls issued back to back without a sync.
    sync()
    t0 = time.perf_counter()
    for _ in range(200):
        paged_attention(*args)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    sync()
    live_pages = sum((p + kq - 1) // page + 1 for p in positions)
    elt = torch.finfo(cfg.dtype).bits // 8
    nbytes = (2 * live_pages * hkv * page * dh * elt  # K and V pages
              + 2 * args[0].numel() * elt  # q in, out
              + args[3].numel() * 4 + args[4].numel() * 4)
    keys = sum(p + k + 1 for p in positions for k in range(kq))
    # QK and PV, each 2 flops per product
    bound_ms, by = bound_of(nbytes, 4 * h * dh * keys)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None, host_us=host_us,
                pages_per_split=kernel_split(*args[:2], args[3]))


def paged_row(cfg, positions, err, name):
    """P1 at ``cfg``'s heads: the verify step (batch 8, K = 4) and decode
    at batch 64 (lengths of phase 1's B=64 cases) on lines of their own,
    then the row of the kernels line, the first decode step of phase 2
    (batch 8, K = 1, 32-page table)."""
    lengths64 = np.random.default_rng(1).integers(1, 2000, size=64).tolist()
    for label, pos, kq in (("B=8 K=4 (verify)", positions, 4),
                           ("B=64 K=1", lengths64, 1)):
        r = time_paged(cfg, pos, kq)
        print(f"  {name} {label}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}; {r['pages_per_split']} pages per split)")
    r = time_paged(cfg, positions, 1)
    print(f"  {name} at the first decode step: "
          f"{r.pop('pages_per_split')} pages per split, host time per "
          f"wrapper call {r.pop('host_us'):.1f} us")
    return dict(r, max_abs_err=err)


def timing_serving(cfg, positions, errs, mini_cfg, mini_positions):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
        flash_attention_reference,
    )

    print("timing at the main path's shapes")
    rows = {}
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    elt = torch.finfo(cfg.dtype).bits // 8
    rows["paged_attention"] = paged_row(cfg, positions, errs["paged"],
                                        "paged_attention")
    # P1 at head_dim 64, mini's 12 / 4 heads.
    rows["paged_attention_d64"] = paged_row(
        mini_cfg, mini_positions, errs["paged_d64"], "paged_attention_d64")
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


def timing_training(cfg, errs, batch=16, seq=2048, tag=""):
    """F1 and F2 at a training step's shape (B=16, S=2048, causal, bf16,
    the heads of ``cfg``: the bench preset's at head_dim 128, moe_bench's
    at 64 with ``tag`` "_d64"). The library time of the backward is
    autograd through scaled_dot_product_attention minus its forward."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_forward,
        flash_attention_reference,
    )

    print(f"timing at the training step's shapes (B={batch}, S={seq}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim})")
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
    rows["flash_fwd_train" + tag] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=library_ms, max_abs_err=errs["flash_train" + tag],
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
    rows["flash_bwd" + tag] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=fwd_bwd_ms - fwd_ms, max_abs_err=errs["flash_bwd" + tag],
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
    laps = [t_start]

    def lap(label):
        laps.append(time.time())
        print(f"{label} took {laps[-1] - laps[-2]:.1f} s")

    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build()
    print(f"  kernels built in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  {name}: " + "; ".join(ptxas_summary(log)))
    lap("phase 0")

    errs = phase1()
    lap("phase 1")

    cfg = PRESETS["llama3_8b"]
    t0 = time.time()
    params = init_params(cfg, args.seed, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    print(f"weights: {cfg.num_params() / 1e9:.2f} B parameters in "
          f"{cfg.dtype}, drawn in {time.time() - t0:.1f} s")
    p2 = phase2(cfg, params, args.seed)
    p3 = phase3(cfg, params, args.seed)
    print(f"serving peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # mini (head_dim 64, 12 / 4 heads) at full width and depth.
    mini = PRESETS["mini"]
    params = init_params(mini, args.seed, device="cuda", dtype=mini.dtype)
    print(f"weights: mini, {mini.num_params() / 1e6:.1f} M parameters in "
          f"{mini.dtype}")
    m2 = phase2(mini, params, args.seed, name="mini")
    m3 = phase3(mini, params, args.seed, name="mini")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    rows = timing_serving(cfg, p2["first_positions"], errs, mini,
                          m2["first_positions"])
    for name, a, b in (("llama3_8b", p2, p3), ("mini", m2, m3)):
        print(f"decode {name}: {a['decode_tokens_per_s']:.1f} tokens/s at "
              f"batch 8, speculative {a['spec_tokens_per_s']:.1f} tokens/s; "
              f"TTFT mean {a['ttft_s_mean']:.3f} s, max "
              f"{a['ttft_s_max']:.3f} s (8 prompts admitted in one step); "
              f"dense 1024-token TTFT {b['ttft_s']:.3f} s [{card}]")
    lap("phases 2-3 and their kernel timing")

    # The serving models go before the trainer's state comes.
    p4 = phase4(args.seed)
    rows.update(timing_training(p4["cfg"], errs))
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 4")
    p5 = phase5(args.seed)
    rows.update(timing_training(p5["cfg"], errs, tag="_d64"))
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 5")
    p6 = phase6(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 6")
    p7 = phase7(args.seed)
    plans = planner_checks(p4, p6, p7)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 7")
    tp_rows = phase8a(p2["first_positions"])
    lap("phase 8a")
    p8 = phase8b(args.seed, p4, p2["outs"])
    lap("phase 8b")
    p9 = phase9(args.seed, p8)
    lap("phase 9")
    prof = p4["profile"]
    print(f"train: {p4['tokens_per_s']:.1f} tokens/s, "
          f"{p4['peak_share']:.2%} of dense bf16 peak, step "
          f"{p4['step_ms']:.1f} ms, peak memory {p4['peak_gib']:.2f} GiB; device per step: flash "
          f"forward {prof['flash_fwd']:.1f} ms, flash backward "
          f"{prof['flash_bwd']:.1f} ms, matmuls {prof['matmul']:.1f} ms, "
          f"other {prof['other']:.1f} ms, idle {prof['idle_share']:.1%}; "
          f"CE alone {p4['ce_ms']:.1f} ms, optimizer alone "
          f"{p4['opt_ms']:.1f} ms; bf16 F2 dq run to run max |ddq| "
          f"{errs['dq_spread']:.3e} [{card}]")
    print("remat modes, bench preset B=16 S=2048, one forward + backward: "
          + "; ".join(f"{k} {v['ms']:.1f} ms {v['peak_gib']:.2f} GiB "
                      f"F1 {v['f1']}" for k, v in p4["modes"].items())
          + f" [{card}]")
    mprof = p5["profile"]
    print(f"MoE train (moe_bench, remat full): {p5['tokens_per_s']:.1f} "
          f"tokens/s, step {p5['step_ms']:.1f} ms, peak memory "
          f"{p5['peak_gib']:.2f} GiB, loss {p5['losses'][0]:.4f} -> "
          f"{p5['losses'][-1]:.4f}, aux {p5['aux'][-1]:.5f}; device per "
          f"step: flash forward {mprof['flash_fwd']:.1f} ms, flash backward "
          f"{mprof['flash_bwd']:.1f} ms, matmuls {mprof['matmul']:.1f} ms, "
          f"other {mprof['other']:.1f} ms, idle {mprof['idle_share']:.1%} "
          f"[{card}]")
    print(f"bench_8b recipe: {p6['tokens_per_s']:.1f} tokens/s, "
          f"{p6['per_layer_ms']:.1f} ms per layer, peak memory "
          f"{p6['peak_gib']:.2f} GiB [{card}]")
    print(f"training loop (bench, TokenDataset): {p7['tokens_per_s']:.1f} "
          f"tokens/s, peak memory {p7['peak'] / 2**30:.2f} GiB; checkpoint "
          f"{p7['ckpt_bytes'] / 1e9:.3f} GB saved in {p7['save_s']:.2f} s, "
          f"restored in {p7['restore_s']:.2f} s; resumed losses within "
          f"{p7['max_rel']:.3e} relative [{card}]")
    print("memory planner, predicted / measured GiB: "
          + "; ".join(f"{k} {v['pred_gib']:.2f} / {v['peak_gib']:.2f} "
                      f"({v['err']:+.1%}, factor {v['factor']:.3f})"
                      for k, v in plans.items()) + f" [{card}]")
    print("tp-rank shapes checked in phase 8a, not on a main path here: "
          + "; ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
                      f"bound {v['bound_ms']:.4f} by {v['bound_by']}, "
                      f"library {v['library_ms']})"
                      for k, v in tp_rows.items() if k not in TP_MAIN_ROWS)
          + f" [{card}]")
    print(f"two ranks on one card over gloo (correctness only): "
          f"llama3_8b tp=2 streams equal to phase 2's: "
          f"{p8['same_streams']} of 8; bench losses fsdp=2 "
          f"{p8['fsdp=2']['losses']}, tp=2 {p8['tp=2']['losses']}, one "
          f"process {p8['single']} [{card}]")
    print(f"phase 9, two ranks on one card over gloo (correctness only): "
          f"pipeline pp=2 loss {p9['pipeline']['loss']:.6f}; sp=2 losses "
          f"{p9['sp=2']['losses']}; tp=2 flash_qkv_ffn8 "
          f"{p9['tp=2 ffn8']['losses']}; moe_bench sp=2 "
          f"{p9['moe sp=2']['losses']}; multislice fsdp=2 "
          f"{p9['multislice fsdp=2']['losses']}; sp=2 flash launches "
          f"{p9['sp=2']['f1']} + {p9['sp=2']['f2']} (both ranks, phase 4's "
          f"shape) [{card}]")
    rows.update({k: tp_rows[k] for k in TP_MAIN_ROWS})
    rows.update(p9["pipeline"]["rows"])
    print(f"run took {time.time() - t_start:.1f} s")
    # One row per kernel and main-path shape: the forward kernel runs in
    # the dense prefill (phase 3) and in training (phase 4).
    launches = {"paged_attention": p2["launches"],
                "paged_attention_d64": m2["launches"],
                "flash_fwd": p3["launches"],
                "flash_fwd_train": p4["f1_launches"],
                "flash_bwd": p4["f2_launches"],
                "flash_fwd_train_d64": p5["f1_launches"],
                "flash_bwd_d64": p5["f2_launches"],
                "paged_attention_tp2": p8["serve_launches"],
                "flash_fwd_train_tp2": p8["tp=2"]["f1"],
                "flash_bwd_tp2": p8["tp=2"]["f2"],
                "flash_fwd_train_pp": p9["pipeline"]["f1"],
                "flash_bwd_pp": p9["pipeline"]["f2"]}
    fwd = ("ray_tpu_torch/csrc/flash_fwd.cu",
           "ray_tpu/ops/pallas/flash_attention.py:48")
    paged = ("ray_tpu_torch/csrc/paged_attention.cu",
             "ray_tpu/ops/pallas/paged_attention.py:59")
    meta = {
        "paged_attention": paged,
        "paged_attention_d64": paged,
        "flash_fwd": fwd,
        "flash_fwd_train": fwd,
        "flash_bwd": ("ray_tpu_torch/csrc/flash_bwd.cu",
                      "ray_tpu/ops/pallas/flash_attention.py:187"),
    }
    meta["flash_fwd_train_d64"] = fwd
    meta["flash_bwd_d64"] = meta["flash_bwd"]
    meta["paged_attention_tp2"] = paged
    meta["flash_fwd_train_tp2"] = fwd
    meta["flash_bwd_tp2"] = meta["flash_bwd"]
    meta["flash_fwd_train_pp"] = fwd
    meta["flash_bwd_pp"] = meta["flash_bwd"]
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
