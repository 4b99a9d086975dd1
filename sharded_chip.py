#!/usr/bin/env python3
"""Measurements behind chip_smoke.py's phase 8 (the sharded path) on one
NVIDIA GPU.

    python3 sharded_chip.py gloo           # which gloo collectives carry CUDA tensors
    python3 sharded_chip.py kernel-faults  # phase 8a's limits: sound and planted readings
    python3 sharded_chip.py train-faults   # phase 8b's limits: sound and planted readings
    python3 sharded_chip.py nccl           # whether NCCL takes two ranks on one card
    python3 sharded_chip.py nccl-ranks     # the NCCL routes (needs 2+ cards)
    python3 sharded_chip.py nccl-train     # the sharded paths on NCCL (needs 4 cards)

``gloo`` runs each collective in a fresh pair of processes (rank 0 and
rank 1 on cuda:0, a gloo process group over a ``file://`` rendezvous), so
one that aborts its process does not hide the others, and prints "ok" with
the values rank 0 saw, or the exit codes and the last line the ranks wrote
to standard error. ray_tpu_torch/parallel/collectives.py copies CUDA
tensors through host memory for a point-to-point send on a gloo group;
this is the record of why.

``nccl`` asks NCCL for two ranks on the one card, twice: in one process
through ``torch.cuda.nccl`` (the route NcclMeshGroup takes across distinct
GPUs), and as two processes of a ``ProcessGroupNCCL`` over a TCPStore
(the route NcclDistGroup takes), and prints each answer. chip_smoke.py
runs its ranks that share the card on the mesh group's device-local route
and NCCL at world 1; this is the record of why.

``nccl-ranks`` needs two or more cards: it runs chip_smoke.py's phase 11a
and 11b with one NcclMeshGroup rank per card (the torch.cuda.nccl route:
every verb against CPU ranks, the bench preset's gradient tree synced
through GradBucketer and timed), then one process per card in a
NcclDistGroup on NCCL (every verb against numpy, partial mode with a late
rank, int8, async, a CUDA send/recv), and times a 256 MiB allreduce on
NCCL (bus bandwidth, nccl-tests' convention). Exits non-zero on any
failed check.

``nccl-train`` needs four cards and raises with fewer. It runs, each time
against the same work in one process on one card: the bench preset at
full width and depth (flash, remat "flash_qkv", B=16 S=2048) under
{"fsdp": 4}, {"tp": 4} (2/1 heads per rank), {"fsdp": 2, "tp": 2}, {"sp": 4}
with ring and with Ulysses attention, five steps each (the first two held
to one process at phase 8b's limits, the last three timed), and the GPipe
schedule over {"pp": 4} (6 layers per stage, phase 9a's program);
moe_bench under {"ep": 4} (phase 9's limits); llama3_8b served under
{"tp": 4} (phase 2's prompts, 64-token pages, 32 greedy tokens: the four
ranks' streams equal, each token held to the plain path by stream_check,
P1 once per layer per decode step); one NCCL rank per card
(chip_smoke.run_ranks), every group's backend checked. Before them, F1/F2
and P1 at the tp = 4 ranks' head layouts against their plain versions and
timed (phase 8a's checks). Last, llama3_8b at all 32 layers and the whole
vocabulary trained under {"fsdp": 4} through TorchTrainer on the port's
runtime: 4 workers of one leased card each on NCCL, remat "full", S=4096,
the largest per-rank batch of 4, 2, 1 the planner admits, 5 steps on one
repeated batch (distinct cards, equal losses and norms on every rank, the
first loss near ln(vocabulary), a falling loss, F1/F2 per layer, a quarter
of the parameters resident per rank, the peak beside the planner's). It
prints per-GPU tokens/s beside the one process's and exits non-zero on any
failed check.

``kernel-faults`` runs phase 8a's checks of F1, F2 and P1 at a tp rank's
head layouts (chip_smoke.TP_FLASH, chip_smoke.TP_PAGED) on the sound
kernels, then on faulty copies of ray_tpu_torch/csrc/flash_fwd.cu,
flash_bwd.cu and paged_attention.cu compiled in a temporary directory and
swapped in through the wrappers' ``_kernel`` / ``_bwd_kernel``. It prints
each kernel's largest reading against the plain version in fp32 (the
largest |got - want| - rtol |want| and the norm-relative error) for the
sound kernels and for each fault, and exits non-zero if a fault passes
chip_smoke.py's limits (FLASH_ORACLE_TOL / _NORM, PAGED_ORACLE_TOL /
_NORM) at any layout, or if a sound kernel fails them.

``train-faults`` runs phase 8b's two-rank bench steps (chip_smoke.
rank_train) under {"fsdp": 2} and {"tp": 2} and phase 9's runs
(chip_smoke.rank_phase9: the pipeline, the steps under tp = 2 with
"flash_qkv_ffn8" and their int8 quantizations, moe_bench under sp = 2,
bench under sp = 2, the multislice fsdp = 2 steps), sound and
with a planted fault patched in the ranks at run time (fsdp's gradient
reduce-scatter, the tp sum of activations or of gradients, the pipeline's
ring shift or its sum of the outputs over pp, the tp max of the int8
scale left out; MoE routed in per-rank groups where the reference's span
the sp ranks), against the same work in one process, and exits non-zero
if a fault passes every limit of its phase (chip_smoke.TWO_RANK_LOSS_REL,
TWO_RANK_NORM_REL, phase9_readings) or a sound run fails one.

The sources in the checkout are never changed. Each exits 1 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import chip_smoke as cs
import paged_attention_chip

# ------------------------------------------------------------------ gloo
GLOO_CASES = ("all_reduce", "all_reduce_bf16", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_to_all_single", "broadcast",
              "send_recv")


def _gloo_case(name, rank, dev):
    x = torch.arange(4.0, device=dev) + 10 * rank
    if name == "all_reduce_bf16":
        x = x.bfloat16()
        dist.all_reduce(x)
        return x.float().tolist(), [10.0, 12.0, 14.0, 16.0]
    if name == "all_reduce":
        dist.all_reduce(x)
        return x.tolist(), [10.0, 12.0, 14.0, 16.0]
    if name == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist(), [0.0, 1, 2, 3, 10, 11, 12, 13]
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist(), [10.0, 12.0]
    if name == "all_to_all_single":
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x)
        return out.tolist(), [0.0, 1, 10, 11]
    if name == "broadcast":
        dist.broadcast(x, 1)
        return x.tolist(), [10.0, 11, 12, 13]
    out = torch.empty(4, device=dev)
    ops = [dist.P2POp(dist.isend, x, 1 - rank),
           dist.P2POp(dist.irecv, out, 1 - rank)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.tolist(), [10.0, 11, 12, 13]


def _gloo_worker(rank, name, path, result, err_path):
    # The rank's standard error goes to a file the parent reads.
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    got, want = _gloo_case(name, rank, torch.device("cuda", 0))
    torch.cuda.synchronize()
    if rank == 0:
        result.put((got, got == want))
    dist.barrier()
    dist.destroy_process_group()


def gloo() -> int:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    ctx = mp.get_context("spawn")
    for name in GLOO_CASES:
        with tempfile.TemporaryDirectory() as d:
            result = ctx.Queue()
            err = [os.path.join(d, f"err{r}") for r in range(2)]
            procs = [ctx.Process(target=_gloo_worker,
                                 args=(r, name, os.path.join(d, "rdzv"),
                                       result, err[r]))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=90)
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            if not result.empty() and codes == [0, 0]:
                got, right = result.get()
                print(f"{name}: ok {got} ({'right' if right else 'WRONG'})",
                      flush=True)
                continue
            last = ""
            for path in err:
                with open(path) as f:
                    lines = [ln.strip() for ln in f if ln.strip()]
                last = last or (lines[-1] if lines else "")
            print(f"{name}: failed, exit codes {codes}: {last[:300]}",
                  flush=True)
    return 0


def _nccl_rank(rank, port, result):
    import datetime

    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          datetime.timedelta(seconds=30))
    try:
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = datetime.timedelta(seconds=30)
        pg = dist.ProcessGroupNCCL(store, rank, 2, opts)
        t = torch.full((4,), float(rank + 1), device="cuda:0")
        ar = dist.AllreduceOptions()
        ar.reduceOp = dist.ReduceOp.SUM
        pg.allreduce([t], ar).wait()
        torch.cuda.synchronize()
        result.put((rank, f"accepted: {t.tolist()}"))
    except Exception as e:  # noqa: BLE001 - the answer is the result
        result.put((rank, f"refused: {type(e).__name__}: "
                    + " ".join(str(e).split())[:300]))


def nccl() -> int:
    import socket

    from torch.cuda import nccl as tnccl

    try:
        pair = [torch.ones(4, device="cuda:0"), torch.ones(4, device="cuda:0")]
        tnccl.all_reduce(pair)
        torch.cuda.synchronize()
        print(f"torch.cuda.nccl, two ranks on cuda:0: accepted "
              f"{pair[0].tolist()}", flush=True)
    except Exception as e:  # noqa: BLE001 - the answer is the result
        print(f"torch.cuda.nccl, two ranks on cuda:0: refused: "
              f"{type(e).__name__}: {e}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    procs = [ctx.Process(target=_nccl_rank, args=(r, port, result))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    answers = {}
    while not result.empty():
        rank, text = result.get()
        answers[rank] = text
    for r in range(2):
        print(f"ProcessGroupNCCL, two processes on cuda:0, rank {r} (exit "
              f"{procs[r].exitcode}): {answers.get(r, 'no answer')}",
              flush=True)
    return 0


NCCL_RANK_ROWS = 16  # rows per rank of the dist verbs' inputs
ALLREDUCE_BYTES = 256 << 20  # the timed NCCL allreduce's payload


def _nccl_dist_rank(rank, world, port, result):
    import asyncio
    import datetime
    import time

    import numpy as np

    from ray_tpu_torch.collective.backends.nccl_group import NcclDistGroup
    from ray_tpu_torch.collective.types import ReduceOp

    torch.cuda.set_device(rank)
    fails = []
    try:
        store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                              datetime.timedelta(seconds=60))
        g = NcclDistGroup(world, rank, timeout_s=60, name="ranks",
                          store=store, dist_backend="nccl")
        shape = (world * NCCL_RANK_ROWS, 33)
        xs = [np.random.default_rng(r).normal(size=shape).astype(np.float32)
              for r in range(world)]
        ints = [np.random.default_rng(100 + r).integers(-8, 9, size=shape)
                .astype(np.float32) for r in range(world)]
        x, xi = (torch.from_numpy(a[rank]).cuda() for a in (xs, ints))
        total, total_i = sum(xs), sum(ints)
        rows = slice(rank * NCCL_RANK_ROWS, (rank + 1) * NCCL_RANK_ROWS)

        def chk(name, got, want, tol=1e-5):
            ok = (got.is_cuda and tuple(got.shape) == want.shape
                  and np.allclose(got.cpu().numpy(), want, rtol=tol,
                                  atol=tol))
            if not ok:
                fails.append(name)

        chk("allreduce", g.allreduce(x), total)
        chk("allreduce ints", g.allreduce(xi), total_i, 0)
        chk("allreduce max", g.allreduce(xi, op=ReduceOp.MAX),
            np.max(ints, axis=0), 0)
        chk("allreduce ring", g.allreduce(x, algo="ring"), total)
        chk("allreduce tree", g.allreduce(x, algo="tree"), total)
        chk("allgather", g.allgather(xi), np.concatenate(ints), 0)
        chk("reducescatter", g.reducescatter(xi), total_i[rows], 0)
        chk("reducescatter tree", g.reducescatter(xi, algo="tree"),
            total_i[rows], 0)
        chk("broadcast", g.broadcast(xi, root=world - 1), ints[-1], 0)
        part = g.allreduce(x, min_ranks=1, grace_s=30.0)
        chk("partial, all in time", part.value, total)
        if part.skipped:
            fails.append(f"partial skipped {part.skipped}")
        g.barrier()
        if rank == world - 1:
            time.sleep(1.0)
        part = g.allreduce(x, min_ranks=1, grace_s=0.3)
        chk("partial, last rank late", part.value,
            sum(xs[:-1]) * (world / (world - 1)), 1e-4)
        if part.skipped != [world - 1]:
            fails.append(f"late rank not skipped: {part.skipped}")
        bound = 2 * np.abs(total).max() / 127
        chk("allreduce int8", g.allreduce(x, compression="int8"), total,
            bound)
        chk("reducescatter int8", g.reducescatter(x, compression="int8"),
            total[rows], bound)
        chk("allgather int8", g.allgather(x, compression="int8"),
            np.concatenate(xs), 2 * max(np.abs(a).max() for a in xs) / 127)
        work = g.allreduce_async(x)
        chk("allreduce_async", work.wait(), total)
        if rank == 0:
            asyncio.run(g.send(x, 1, seq=7))
        elif rank == 1:
            chk("send/recv", asyncio.run(g.recv(0, seq=7)), xs[0], 0)
        g.barrier()
        big = torch.ones(ALLREDUCE_BYTES // 4, device="cuda")
        for _ in range(3):
            g.allreduce(big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 10
        for _ in range(iters):
            g.allreduce(big)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        if g.last_route != "nccl":
            fails.append(f"route {g.last_route}")
        asyncio.run(g.destroy())
        result.put((rank, fails, ms))
    except Exception as e:  # noqa: BLE001 - reported, and the mode fails
        result.put((rank, fails + [f"{type(e).__name__}: {e}"], None))


def nccl_ranks() -> int:
    import socket

    n = torch.cuda.device_count()
    if n < 2:
        print(f"nccl-ranks needs two or more cards, this machine has {n}")
        return 1
    devices = tuple(f"cuda:{i}" for i in range(n))
    bad = []
    try:
        # NCCL sums bf16 in its own order: a few bf16 steps apart.
        card, worst = cs.mesh_verbs(0, devices=devices, route="nccl",
                                    bf16_steps=4)
        print(f"mesh group, {n} cards: {worst}", flush=True)
        sync = cs.bucket_sync(card, 0)
        print(f"GradBucketer on {n} cards: {sync}", flush=True)
    except cs.SmokeFailure as e:
        bad.append(f"mesh: {e}")
        print(f"mesh group FAILED: {e}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    procs = [ctx.Process(target=_nccl_dist_rank, args=(r, n, port, result))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    for _ in range(n):
        try:
            rank, fails, ms = result.get(timeout=300)
        except Exception:  # noqa: BLE001 - a rank that never answered
            break
        got[rank] = (fails, ms)
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join()
    for r in range(n):
        fails, ms = got.get(r, (["no answer"], None))
        bus = (2 * (n - 1) / n * ALLREDUCE_BYTES / (ms * 1e-3) / 1e9
               if ms else float("nan"))
        print(f"NcclDistGroup rank {r} of {n} on NCCL: failures {fails}; "
              f"{ALLREDUCE_BYTES} B allreduce {ms} ms, bus bandwidth "
              f"{bus:.1f} GB/s", flush=True)
        bad += [f"rank {r}: {f}" for f in fails]
    print(f"failures: {bad}")
    return 1 if bad else 0


# ------------------------------------------------------------ nccl-train
NT_WORLD = 4
# Steps of each mesh run: the first NT_CHECKED held to one process, the
# rest timed after them (two warm-up steps).
NT_STEPS, NT_CHECKED = 5, 2
# bench at full width and depth under each mesh: (axis sizes, attention).
# "flash": F1/F2 per shard; "ring": the plain block attention of
# parallel/ring_attention.py (no flash launch: its combine differentiates
# through each block's row max and sum); "ulysses": F1/F2 on the
# all-to-all's whole sequences at 2/1 heads.
NT_MESHES = {
    "fsdp=4": ({"fsdp": 4}, "flash"),
    "tp=4": ({"tp": 4}, "flash"),
    "fsdp=2,tp=2": ({"fsdp": 2, "tp": 2}, "flash"),
    "sp=4 ring": ({"sp": 4}, "ring"),
    "sp=4 ulysses": ({"sp": 4}, "ulysses"),
}
# The kernels at the tp = 4 ranks' head layouts (phase 8a's checks and
# timing): F1/F2 at bench's 8/4 heads over 4 ranks, P1 at llama3_8b's.
TP4_FLASH = (("bench tp=4", (2, 1, 128), (16, 2048), "_tp4"),)
TP4_PAGED = (("llama3_8b tp=4", (8, 2, 128), "_tp4"),)
# llama3_8b trained through TorchTrainer under {"fsdp": 4}: every layer,
# the whole vocabulary, S = 4096, the largest per-rank batch of these the
# planner admits.
FIT_SEQ, FIT_BATCHES = 4096, (4, 2, 1)
FIT_STEPS, FIT_WARM = 5, 2
# The first loss on random weights: ln(vocabulary) plus half the logits'
# variance. The final norm's output has unit rms and lm_head is drawn from
# a normal truncated to [-2, 2] times fan_in**-0.5, so a logit's variance
# is that truncated normal's, 1 - 4 phi(2) / (Phi(2) - Phi(-2)) = 0.774
# (moe_bench's first loss in phase 5, 10.788 = ln 32768 + 0.387).
FIT_LOGIT_VAR = 1 - 4 * (math.exp(-2) / math.sqrt(2 * math.pi)) / math.erf(
    2 / math.sqrt(2))
FIT_LOSS0_TOL = 0.1


def _nt_bench(impl):
    from ray_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(PRESETS["bench"], attn_impl=impl)


def _nt_moe():
    """moe_bench with flash attention (phase 5's model)."""
    from ray_tpu_torch.models.moe import MOE_PRESETS

    return dataclasses.replace(MOE_PRESETS["moe_bench"], attn_impl="flash")


def _busy_ms(spans):
    """The union of (start, end) intervals in microseconds, in ms."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _device_profile(fn, calls):
    """``fn`` called ``calls`` times under torch.profiler after a sync,
    per call: the wall ms, the ms this rank's card was busy (the union of
    its kernels' and copies' intervals), of them NCCL's kernels, and the
    idle share of the wall. A reading, not a check: where the profiler
    itself fails, the calls run without it and the error is kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    in_calls = False
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            in_calls = True
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / calls
            in_calls = False
        events = prof.events()
    except RuntimeError as e:
        if in_calls:  # the calls' own fault, not the profiler's
            raise
        return dict(error=f"{type(e).__name__}: {str(e)[:200]}")
    spans = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower())
             for e in events if e.device_type == DeviceType.CUDA]
    busy = _busy_ms([s[:2] for s in spans]) / calls
    nccl = _busy_ms([s[:2] for s in spans if s[2]]) / calls
    return dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl,
                idle=1 - busy / wall if wall else None)


def _profile_step(state, step, data):
    """One more train step under the profiler (rank 0 reads it)."""
    box = [state]

    def one():
        box[0], _ = step(box[0], data)

    return _device_profile(one, 1)


def _nt_run(seed, sizes, cfg):
    """One rank's NT_STEPS steps of ``cfg`` under ``sizes``, with the
    backend of every axis of its mesh, and one more step profiled."""
    from ray_tpu_torch.parallel.mesh import make_mesh

    seen = {}

    def build():
        mesh = make_mesh(sizes)
        seen.update(cs.mesh_backends(mesh))
        return mesh

    out = cs.rank_train(seed, build, cfg=cfg, steps=NT_STEPS,
                        inspect=_profile_step)
    out["backends"] = seen
    return out


def _profile_decode(eng, prompts):
    """Four pure decode steps of the batch under the profiler, after its
    prefill."""
    from ray_tpu_torch.llm.engine import SamplingParams

    for p in prompts:
        eng.add_request(p, SamplingParams(max_tokens=8))
    eng.step()
    out = _device_profile(eng.step, 4)
    while eng.has_unfinished():
        eng.step()
    return out


def _nccl_train_rank(seed):
    """One NCCL rank of nccl-train: bench under each of NT_MESHES, the
    pipeline over pp = 4, moe_bench under ep = 4, llama3_8b served under
    tp = 4."""
    out = {"default": dist.get_backend(),
           "device": torch.cuda.current_device()}
    for name, (sizes, impl) in NT_MESHES.items():
        out[name] = _nt_run(seed, sizes, _nt_bench(impl))
    out["pp=4"] = cs.rank_pipeline(seed, stages=NT_WORLD,
                                   repeats=NT_STEPS - NT_CHECKED + 1)
    out["moe ep=4"] = _nt_run(seed, {"ep": NT_WORLD}, _nt_moe())
    out["serve tp=4"] = cs.rank_serve(seed, NT_WORLD,
                                      inspect=_profile_decode)
    return out


def _per_gpu(tokens, walls):
    """Per-GPU tokens/s of a mesh run: the global batch's tokens over the
    mean wall of the timed steps (after NT_CHECKED), over the ranks."""
    timed = walls[NT_CHECKED:]
    return tokens / (sum(timed) / len(timed)) / NT_WORLD


def _fit_loop(config):
    """TorchTrainer's loop on each of the 4 workers: llama3_8b under
    {"fsdp": 4} on the worker's leased card, FIT_STEPS steps on one
    repeated batch; every rank's losses and gradient norms gathered over
    the trainer's NCCL collective group; this rank's readings written to
    ``config["out"]/<rank>.json``."""
    import ray_tpu_torch.collective as col
    import ray_tpu_torch.train as train
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import local
    from ray_tpu_torch.train import step as tstep

    loop_start = time.time()
    ctx = train.get_context()
    cfg = _fit_config()
    mesh = make_mesh({"fsdp": ctx.world_size})
    backends = {"default": dist.get_backend(),
                **{a: dist.get_backend(mesh.get_group(a))
                   for a, n in zip(mesh.mesh_dim_names, mesh.shape) if n > 1}}
    opt = tstep.make_optimizer(warmup=0, total_steps=1000,
                               mu_dtype=torch.bfloat16)
    state = tstep.init_train_state(cfg, opt, seed=config["seed"],
                                   device="cuda", mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.time() - loop_start
    resident = sum(local(v).numel() * local(v).element_size()
                   for _, v in tstep._flatten(state.params))
    step = tstep.jit_train_step(cfg, opt, mesh)
    rng = np.random.default_rng(config["seed"])
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size,
        (config["batch"] * ctx.world_size, FIT_SEQ + 1))).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls, f1, f2 = [], [], [], [], []
    for _ in range(FIT_STEPS):
        flash_attention_forward.launches = 0
        flash_attention_backward.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        f1.append(flash_attention_forward.launches)
        f2.append(flash_attention_backward.launches)
    peak = torch.cuda.max_memory_allocated()
    group = train.collective_group_name()
    every = col.allgather(torch.tensor(losses + norms, device="cuda",
                                       dtype=torch.float64),
                          group_name=group)
    rec = dict(rank=ctx.rank, cards=os.environ.get("CUDA_VISIBLE_DEVICES"),
               device_count=torch.cuda.device_count(), backends=backends,
               route=col.get_group(group).last_route,
               every=every.reshape(ctx.world_size, -1).tolist(),
               losses=losses, norms=norms, walls=walls, f1=f1, f2=f2,
               peak=peak, resident=resident, whole=cfg.num_params() * 4,
               init_s=init_s, loop_start=loop_start,
               ln_vocab=math.log(cfg.vocab_size))
    with open(os.path.join(config["out"], f"{ctx.rank}.json"), "w") as f:
        json.dump(rec, f)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    train.report({"loss": losses[-1]})


def _fit_batch():
    """The largest of FIT_BATCHES the planner admits per rank, and its
    plan."""
    from ray_tpu_torch.train import memory

    cfg = dataclasses.replace(_fit_config(), remat="full")
    for b in FIT_BATCHES:
        p = memory.plan(cfg, b, FIT_SEQ, mu_dtype="bfloat16", hbm_gb=80.0,
                        fsdp=NT_WORLD)
        if p.fits:
            return b, p
    raise cs.SmokeFailure("the planner admits no batch of llama3_8b at "
                          f"fsdp={NT_WORLD}")


def _fit_config():
    from ray_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(PRESETS["llama3_8b"], attn_impl="flash",
                               remat="full")


def nccl_fit(seed, bad):
    """llama3_8b at full depth under fsdp = 4 through TorchTrainer on the
    port's own runtime: 4 workers of one leased card each, NCCL."""
    import json
    import shutil

    import ray_tpu_torch
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = _fit_config()
    batch, plan = _fit_batch()
    print(f"llama3_8b fsdp={NT_WORLD} through TorchTrainer: "
          f"{cfg.num_params() / 1e9:.2f} B parameters, {cfg.n_layers} layers, "
          f"vocabulary {cfg.vocab_size}, S={FIT_SEQ}, per-rank batch {batch} "
          f"(planned {plan.total_gb:.2f} GiB)", flush=True)
    out = tempfile.mkdtemp(prefix="nccl_fit_")
    ray_tpu_torch.init(num_cpus=8)
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU")
        t0 = time.time()
        result = TorchTrainer(
            _fit_loop, train_loop_config={"seed": seed, "batch": batch,
                                          "out": out},
            scaling_config=ScalingConfig(
                num_workers=NT_WORLD, use_gpu=True, gpus_per_worker=1,
                distributed=True, dist_backend="nccl"),
            run_config=RunConfig(name="nccl_fit", storage_path=out),
        ).fit()
        fit_s = time.time() - t0
        if result.error is not None:
            bad.append(f"fit: {result.error!r}")
            print(f"fit FAILED: {result.error!r}", flush=True)
            return
        recs = []
        for r in range(NT_WORLD):
            with open(os.path.join(out, f"{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(out, ignore_errors=True)

    def need(ok, text):
        print(f"  {'ok' if ok else 'FAILED'}: {text}", flush=True)
        if not ok:
            bad.append(f"fit: {text}")

    r0 = recs[0]
    cards = [r["cards"] for r in recs]
    need(len(set(cards)) == NT_WORLD and all(r["device_count"] == 1
                                             for r in recs),
         f"the node had {gpus} GPUs; each worker sees one card of its own: "
         f"CUDA_VISIBLE_DEVICES {cards}")
    need(all(set(r["backends"].values()) == {"nccl"} for r in recs)
         and all(r["route"] == "nccl" for r in recs),
         f"every group on NCCL: {r0['backends']}, the collective group's "
         f"route {[r['route'] for r in recs]}")
    same = all(r["every"] == r0["every"] for r in recs) and all(
        row == r0["losses"] + r0["norms"] for row in r0["every"])
    need(same, f"every rank reports the same losses {r0['losses']} and "
         f"gradient norms {r0['norms']}")
    want0 = r0["ln_vocab"] + FIT_LOGIT_VAR / 2
    need(abs(r0["losses"][0] - want0) <= FIT_LOSS0_TOL,
         f"first loss {r0['losses'][0]:.4f} within {FIT_LOSS0_TOL} of "
         f"ln({cfg.vocab_size}) + {FIT_LOGIT_VAR:.4f} / 2 = {want0:.4f}")
    need(all(b < a for a, b in zip(r0["losses"], r0["losses"][1:])),
         f"the loss falls on the repeated batch: {r0['losses']}")
    # remat "full" replays each layer's forward, F1 included, in the
    # backward pass.
    need(all(r["f1"] == [2 * cfg.n_layers] * FIT_STEPS
             and r["f2"] == [cfg.n_layers] * FIT_STEPS for r in recs),
         f"F1 {2 * cfg.n_layers} (forward and its replay) and F2 "
         f"{cfg.n_layers} launches per step on every rank: "
         f"{[(r['f1'][0], r['f2'][0]) for r in recs]}")
    need(all(r["resident"] * NT_WORLD == r["whole"] for r in recs),
         f"each rank holds a quarter of the {r0['whole'] / 2**30:.2f} GiB "
         f"fp32 parameters: {[r['resident'] / 2**30 for r in recs]} GiB")
    walls = r0["walls"][FIT_WARM:]
    step_s = sum(walls) / len(walls)
    tps = batch * FIT_SEQ / step_s
    share = tps * cfg.flops_per_token(FIT_SEQ) / cs.BF16_FLOPS
    loop_wait = min(r["loop_start"] for r in recs) - t0
    print(f"  llama3_8b fsdp={NT_WORLD}: steps {[round(w, 3) for w in r0['walls']]}"
          f" s; per-GPU {tps:.1f} tokens/s over steps {FIT_WARM}-"
          f"{FIT_STEPS - 1}, {share:.3f} of the dense bf16 peak "
          f"({cfg.flops_per_token(FIT_SEQ) / 1e9:.2f} GFLOP per token); "
          f"fit {fit_s:.1f} s, {loop_wait:.1f} s of it before the loop, "
          f"init {r0['init_s']:.1f} s in the loop", flush=True)
    for r in recs:
        err = plan.total_bytes / r["peak"] - 1
        print(f"  rank {r['rank']} (card {r['cards']}): peak "
              f"{r['peak'] / 2**30:.2f} GiB, planner {plan.total_gb:.2f} GiB,"
              f" error {err:+.3f}", flush=True)


def _fmt_profile(p):
    if "error" in p:
        return f"not taken ({p['error']})"
    return (f"wall {p['wall_ms']:.1f} ms, card busy {p['busy_ms']:.1f} ms "
            f"(NCCL {p['nccl_ms']:.1f}), idle {p['idle']:.3f}")


def _check_mesh_run(name, ranks, single, bad, tokens, flops, launches):
    """A bench or moe_bench mesh run's checks and readings against the
    one-process run ``single``; ``launches``: each rank's (F1, F2).
    Every rank must report the same losses and gradient norms, under ep
    too (the train step makes the replicated leaves' gradients one value
    over ep)."""
    moe = name.startswith("moe")
    loss_lim = cs.MOE_LOSS_REL if moe else cs.TWO_RANK_LOSS_REL
    norm_lim = cs.MOE_NORM_REL if moe else cs.TWO_RANK_NORM_REL
    r0 = ranks[0]
    fails = []
    if any(r["losses"] != r0["losses"] or r["norms"] != r0["norms"]
           for r in ranks):
        fails.append("the ranks report different losses or norms: "
                     f"{[(r['losses'], r['norms']) for r in ranks]}")

    def rel(key, r):
        return [cs._rel(a, b) for a, b in zip(r[key][:NT_CHECKED],
                                              single[key])]

    loss = [max(x) for x in zip(*(rel("losses", r) for r in ranks))]
    norm = [max(x) for x in zip(*(rel("norms", r) for r in ranks))]
    aux = [max(x) for x in zip(*(rel("aux", r) for r in ranks))]
    if max(loss) > loss_lim or max(norm) > norm_lim or max(
            aux, default=0.0) > cs.MOE_AUX_REL:
        fails.append("off the one process")
    if any(set(r["backends"].values()) != {"nccl"} for r in ranks):
        fails.append(f"a group not on NCCL: {r0['backends']}")
    if any((r["f1"], r["f2"]) != launches for r in ranks):
        fails.append(f"F1/F2 launches {[(r['f1'], r['f2']) for r in ranks]}"
                     f", expected {launches}")
    tps = _per_gpu(tokens, r0["wall"])
    print(f"{name}: losses {r0['losses'][:NT_CHECKED]} (worst rank, rel "
          + ", ".join(f"{x:.2e}" for x in loss) + f", limit {loss_lim}), "
          f"grad_norms rel " + ", ".join(f"{x:.2e}" for x in norm)
          + f" (limit {norm_lim})"
          + (f", aux rel " + ", ".join(f"{x:.2e}" for x in aux)
             + f" (limit {cs.MOE_AUX_REL})" if aux else "")
          + f"; F1 {r0['f1']} F2 {r0['f2']} per rank over {NT_STEPS} steps; "
          f"groups {r0['backends']}; per-GPU {tps:.1f} tokens/s"
          + (f", {tps * flops / cs.BF16_FLOPS:.3f} of the dense bf16 peak"
             if flops else "")
          + f"; peak {max(r['peak'] for r in ranks) / 2**30:.2f} GiB; "
          + f"a profiled step on rank 0: {_fmt_profile(r0['inspect'])}; "
          + ("ok" if not fails else f"FAILED: {fails}"), flush=True)
    bad += [f"{name}: {f}" for f in fails]
    return tps


def _nt_kernels(seed):
    """F1/F2 and P1 at the tp = 4 ranks' head layouts against their plain
    versions (phase 8a's checks), then timed; returns their rows."""
    from ray_tpu_torch.models.llama import PRESETS

    positions = [len(p) for p in cs.serving_prompts(
        PRESETS["llama3_8b"], np.random.default_rng(seed))]
    rows = {}
    for label, heads, (b, s), tag in TP4_FLASH:
        print(f"{label}: heads {heads[0]}/{heads[1]} of {heads[2]}, "
              f"B={b} S={s}", flush=True)
        errs = cs.flash_bwd_checks({torch.bfloat16: cs.FLASH_BF16_TOL},
                                   heads=heads, shapes=((b, s),),
                                   dtypes=(torch.bfloat16,), train=(b, s),
                                   tag=tag, oracle=True)
        rows.update(cs.timing_training(cs.heads_cfg(heads), errs, batch=b,
                                       seq=s, tag=tag))
    for label, heads, tag in TP4_PAGED:
        print(f"{label}: heads {heads[0]}/{heads[1]} of {heads[2]}",
              flush=True)
        err = cs.paged_checks(heads=heads, oracle=True)
        rows["paged_attention" + tag] = cs.paged_row(
            cs.heads_cfg(heads), positions, err, "paged_attention" + tag)
    print(f"kernels at the tp={NT_WORLD} shapes: {json.dumps(rows)}",
          flush=True)
    return rows


def _nt_single(seed, bad):
    """The one-process runs the ranks are held to, on cuda:0."""
    t0 = time.time()
    out = {"bench": cs.rank_train(seed, None, cfg=_nt_bench("flash"),
                                  steps=NT_STEPS)}
    single = out["bench"]
    out["tps"] = 16 * 2048 / (sum(single["wall"][NT_CHECKED:])
                              / (NT_STEPS - NT_CHECKED))
    flops = _nt_bench("flash").flops_per_token(2048)
    print(f"bench in one process: losses {single['losses']}, grad_norms "
          f"{single['norms']}, F1 {single['f1']} F2 {single['f2']}; "
          f"{out['tps']:.1f} tokens/s, "
          f"{out['tps'] * flops / cs.BF16_FLOPS:.3f} of the dense bf16 peak "
          f"(phase 4: 62.8k, PERF.md)", flush=True)
    n_bench = _nt_bench("flash").n_layers * NT_STEPS
    if (single["f1"], single["f2"]) != (n_bench, n_bench):
        bad.append(f"one process: F1 {single['f1']} F2 {single['f2']}, "
                   f"expected one per layer and step, {n_bench}")
    out["pipeline"] = cs.pipeline_single(seed)
    print(f"pipeline in one process: loss {out['pipeline']['loss']:.6f}, F1 "
          f"{out['pipeline']['f1']} F2 {out['pipeline']['f2']}, "
          f"{out['pipeline']['wall']:.2f} s", flush=True)
    out["moe"] = cs.rank_train(seed, None, cfg=_nt_moe(), steps=NT_STEPS)
    print(f"moe_bench in one process: losses {out['moe']['losses']}, aux "
          f"{out['moe']['aux']}, F1 {out['moe']['f1']} F2 "
          f"{out['moe']['f2']}", flush=True)
    print(f"one-process runs took {time.time() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _nt_ranks(seed, one, bad):
    """One NCCL rank per card: every mesh run against ``one`` (the
    one-process runs); returns per-GPU tokens/s by mesh."""
    from ray_tpu_torch.models.llama import PRESETS, init_params

    t0 = time.time()
    ranks = cs.run_ranks(_nccl_train_rank, (seed,), world=NT_WORLD,
                         backend="nccl", timeout=1500)
    print(f"{NT_WORLD} NCCL ranks ran in {time.time() - t0:.1f} s", flush=True)
    if [r["device"] for r in ranks] != list(range(NT_WORLD)) or {
            r["default"] for r in ranks} != {"nccl"}:
        bad.append(f"ranks' devices {[r['device'] for r in ranks]}, default "
                   f"groups {[r['default'] for r in ranks]}")
    single = one["bench"]
    bench_flops = _nt_bench("flash").flops_per_token(2048)
    tps = {}
    for name, (_, impl) in NT_MESHES.items():
        # One F1 and one F2 per layer and step, as in one process; the
        # ring's blocks launch none.
        launches = (0, 0) if impl == "ring" else (single["f1"], single["f2"])
        tps[name] = _check_mesh_run(name, [r[name] for r in ranks], single,
                                    bad, 16 * 2048, bench_flops, launches)
    pipe = [r["pp=4"] for r in ranks]
    pipe_fails = []
    for i, r in enumerate(pipe):
        text, ok = cs.phase9_readings("pipeline", r, one["pipeline"])
        if not ok:
            pipe_fails.append(f"rank {i}: {text}")
    # Each rank runs (M + P - 1) microbatch steps of its 6 layers.
    n_pipe = (cs.PIPE_MICRO + NT_WORLD - 1) * (
        _nt_bench("flash").n_layers // NT_WORLD)
    if any((r["f1"], r["f2"]) != (n_pipe, n_pipe) for r in pipe):
        pipe_fails.append(f"F1/F2 {[(r['f1'], r['f2']) for r in pipe]}, "
                          f"expected {n_pipe} each")
    if any(set(r["backends"].values()) != {"nccl"} for r in pipe):
        pipe_fails.append(f"groups {pipe[0]['backends']}")
    walls = pipe[0]["walls"][1:]
    tps["pp=4"] = 16 * 2048 / (sum(walls) / len(walls)) / NT_WORLD
    print(f"pp=4: {cs.phase9_readings('pipeline', pipe[0], one['pipeline'])[0]}"
          f"; F1 {pipe[0]['f1']} F2 {pipe[0]['f2']} per rank; groups "
          f"{pipe[0]['backends']}; per-GPU {tps['pp=4']:.1f} tokens/s "
          f"(forward and backward, no optimizer), "
          f"{tps['pp=4'] * bench_flops / cs.BF16_FLOPS:.3f} of the peak; "
          + ("ok" if not pipe_fails else f"FAILED: {pipe_fails}"),
          flush=True)
    bad += [f"pp=4: {f}" for f in pipe_fails]
    _check_mesh_run("moe ep=4", [r["moe ep=4"] for r in ranks], one["moe"],
                    bad, 16 * 2048, None, (one["moe"]["f1"], one["moe"]["f2"]))

    llama = PRESETS["llama3_8b"]
    sv = [r["serve tp=4"] for r in ranks]
    serve_fails = []
    if any(r["outs"] != sv[0]["outs"] for r in sv):
        serve_fails.append("the ranks emitted different streams")
    if not all(len(o) == 32 for o in sv[0]["outs"]):
        serve_fails.append("a request did not finish with 32 tokens")
    for r in sv:
        if r["kv_heads"] != llama.n_kv_heads // NT_WORLD:
            serve_fails.append(f"a rank's pool holds {r['kv_heads']} KV heads")
        if r["launches"] != llama.n_layers * r["decode_steps"]:
            serve_fails.append(f"P1 {r['launches']} for {r['decode_steps']} "
                               f"decode steps")
    params = init_params(llama, seed, device="cuda", dtype=llama.dtype)
    prompts = cs.serving_prompts(llama, np.random.default_rng(seed))
    try:
        cs.stream_check(llama, params, prompts, sv[0]["outs"], "tp=4 greedy")
    except cs.SmokeFailure as e:
        serve_fails.append(str(e))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve llama3_8b tp={NT_WORLD}: {sv[0]['decode_steps']} decode "
          f"steps, P1 {[r['launches'] for r in sv]} per rank, "
          f"{sv[0]['kv_heads']} KV heads per rank, decode "
          f"{sv[0]['decode_tps']:.1f} tokens/s "
          f"({sv[0]['decode_tps'] / NT_WORLD:.1f} per GPU), peak "
          f"{max(r['peak'] for r in sv) / 2**30:.2f} GiB; decode steps "
          f"profiled on rank 0: {_fmt_profile(sv[0]['inspect'])}; "
          + ("ok" if not serve_fails else f"FAILED: {serve_fails}"),
          flush=True)
    bad += [f"serve tp=4: {f}" for f in serve_fails]
    return tps


def nccl_train(seed=0) -> int:
    """nccl-train: the sharded paths over NCCL, one process per card. Each
    part runs whatever the one before it did; every failure is listed."""
    from ray_tpu_torch import _build
    from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

    n = torch.cuda.device_count()
    if n < NT_WORLD:
        raise RuntimeError(f"nccl-train needs {NT_WORLD} cards; this machine "
                           f"has {n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    print(f"{n} cards; card ids {GPUAcceleratorManager().detect_ids()}; "
          f"CUDA_VISIBLE_DEVICES "
          f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}", flush=True)
    bad = []
    _build.build()
    print(f"kernels built in {time.time() - t_start:.1f} s", flush=True)

    def part(name, fn, *args):
        t0 = time.time()
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - listed, and the mode fails
            bad.append(f"{name}: {type(e).__name__}: {str(e)[:3000]}")
            print(f"{name} FAILED: {type(e).__name__}: {e}", flush=True)
        finally:
            print(f"{name} took {time.time() - t0:.1f} s", flush=True)

    part("kernels", _nt_kernels, seed)
    one = part("one process", _nt_single, seed, bad)
    tps = part("ranks", _nt_ranks, seed, one, bad) if one else None
    if tps:
        print("per-GPU train tokens/s: " + json.dumps(
            {**{k: round(v, 1) for k, v in tps.items()},
             "one process (this run)": round(one["tps"], 1),
             "phase 4 (PERF.md)": 62790.0}), flush=True)
    part("fit", nccl_fit, seed, bad)
    print(f"nccl-train took {time.time() - t_start:.1f} s")
    print(f"failures: {bad}")
    return 1 if bad else 0


# --------------------------------------------------------- kernel faults
# (source file, wrapper's kernel getter, {fault: (sound text, faulty text)})
KERNEL_FAULTS = {
    "F1": ("flash_fwd.cu", "_kernel", {
        "key tile 1 left out of p . v": (
            "    start_pv<D>(o, p, vs);\n",
            "    if (kt != 1) start_pv<D>(o, p, vs);\n"),
        "no rescale of O by exp(m_old - m_new)": (
            "    rescale<D>(o, alpha);\n", "    ;\n"),
        "causal mask one key late": (
            "if (key >= seq || (diag && key > qpos)) s[i] = kMask;",
            "if (key >= seq || (diag && key > qpos + 1)) s[i] = kMask;"),
    }),
    "F2": ("flash_bwd.cu", "_bwd_kernel", {
        "delta left out of ds": (
            "          dpt[i] = p * (dpt[i] - dl);",
            "          dpt[i] = p * dpt[i];"),
        "dq of key tile 1 left out": (
            "      if (s < seq) {\n        if (odd)",
            "      if (s < seq && blockIdx.y != 1) {\n        if (odd)"),
        "first query step left out of dk": (
            "      wgmma_rs<D, 1>(dk, dsa[kk], desc_mn_major(qs, TQ, 0, kk), "
            "1);",
            "      if (it != 0) wgmma_rs<D, 1>(dk, dsa[kk], "
            "desc_mn_major(qs, TQ, 0, kk), 1);"),
        "causal mask one key late": (
            "(a.causal && key > q0 + qc)) sv = kMask;",
            "(a.causal && key > q0 + qc + 1)) sv = kMask;"),
    }),
    "P1": ("paged_attention.cu", "_kernel", paged_attention_chip.FAULTS),
}
MODULES = {"F1": "ray_tpu_torch.ops.flash_attention",
           "F2": "ray_tpu_torch.ops.flash_attention",
           "P1": "ray_tpu_torch.ops.paged_attention"}
# The comparisons of each kernel's own outputs in phase 8a's checks.
OUTPUTS = {"F1": (" O vs fp32",),
           "F2": (" dq vs fp32", " dk vs fp32", " dv vs fp32"),
           "P1": (" vs fp32",)}


def _compile_faults():
    """Start one nvcc per fault; returns {(kernel, fault): (process,
    library path)}."""
    from ray_tpu_torch import _build

    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for kern, (src_name, _, faults) in KERNEL_FAULTS.items():
        src = (_build._CSRC / src_name).read_text()
        for i, (name, (good, bad)) in enumerate(faults.items()):
            if src.count(good) != 1:
                raise SystemExit(f"{kern} {name}: the source text to plant "
                                 f"it in moved")
            path = tmp / f"{kern}_{i}.cu"
            path.write_text(src.replace(good, bad))
            lib = tmp / f"lib{kern}_{i}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                   str(_build._CSRC), "-o", str(lib), str(path)]
            procs[kern, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    return procs


@contextlib.contextmanager
def _recording():
    """chip_smoke's compare and check record readings instead of failing:
    yields the list of (name, excess over rtol, norm-relative error,
    passed)."""
    seen = []
    real_compare, real_check = cs.compare, cs.check

    def compare(name, got, want, atol, rtol, norm=None):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        finite = bool(torch.isfinite(got).all())
        excess = (float((err - rtol * want.abs()).max()) if finite
                  else float("inf"))
        rel = float(err.norm() / want.norm()) if finite else float("inf")
        ok = excess <= atol and (norm is None or rel <= norm)
        seen.append((name, excess, rel, ok))
        return float(err.max()) if finite else float("inf")

    cs.compare, cs.check = compare, lambda cond, msg: None
    try:
        yield seen
    finally:
        cs.compare, cs.check = real_compare, real_check


def _phase8a_readings(kern):
    """{layout: [(name, excess, norm-rel, passed)]} of ``kern``'s own
    outputs in phase 8a's checks, with the kernels as they are now."""
    out = {}
    flash = kern in ("F1", "F2")
    layouts = cs.TP_FLASH if flash else cs.TP_PAGED
    for label, heads, *rest in layouts:
        with _recording() as seen:
            if flash:
                (b, s), tag = rest
                cs.flash_bwd_checks({torch.bfloat16: cs.FLASH_BF16_TOL},
                                    heads=heads, shapes=((b, s),),
                                    dtypes=(torch.bfloat16,), train=(b, s),
                                    tag=tag, oracle=True)
            else:
                cs.paged_checks(heads=heads, oracle=True)
        out[label] = [r for r in seen if r[0].endswith(OUTPUTS[kern])]
    return out


def _summary(label, rows):
    ex = max(r[1] for r in rows)
    rel = max(r[2] for r in rows)
    failed = sum(not r[3] for r in rows)
    return ex, rel, failed, (f"{label}: largest beyond rtol {ex:.3e}, "
                             f"largest norm-rel {rel:.3e}, {failed} of "
                             f"{len(rows)} comparisons fail the limits")


def kernel_faults() -> int:
    procs = _compile_faults()
    bad = []
    print(f"limits: F1/F2 {cs.FLASH_ORACLE_TOL} norm {cs.FLASH_ORACLE_NORM}; "
          f"P1 {cs.PAGED_ORACLE_TOL} norm {cs.PAGED_ORACLE_NORM}")
    for kern in ("F1", "F2", "P1"):
        for layout, rows in _phase8a_readings(kern).items():
            _, _, failed, text = _summary(f"{kern} sound | {layout}", rows)
            print("SOUND " + text, flush=True)
            if failed:
                bad.append(f"{kern} sound at {layout}")
    for (kern, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{kern} {name}: nvcc failed\n{log}")
        mod = importlib.import_module(MODULES[kern])
        getter = KERNEL_FAULTS[kern][1]
        real = getattr(mod, getter)
        fn = getattr(ctypes.CDLL(str(lib)), real().__name__)
        fn.restype, fn.argtypes = ctypes.c_int, real().argtypes
        setattr(mod, getter, lambda fn=fn: fn)
        try:
            readings = _phase8a_readings(kern)
        finally:
            setattr(mod, getter, real)
        for layout, rows in readings.items():
            _, _, failed, text = _summary(f"{kern} {name} | {layout}", rows)
            print("FAULT " + text, flush=True)
            if not failed:
                bad.append(f"{kern} {name} at {layout}")
    if bad:
        print(f"wrong side of the limits: {bad}")
    return 1 if bad else 0


# ---------------------------------------------------------- train faults
def _no_reduce_scatter(x, mesh, axes, dim):
    from ray_tpu_torch.parallel import collectives as col

    return col.local_chunk(x, mesh, axes, dim).contiguous()


def _no_pp_sum(real):
    """collectives.reduce_from with the sum over pp left out (the
    pipeline's outputs stay on the last stage)."""

    def reduce_from(x, mesh, axes, mean=False):
        return x if axes == "pp" else real(x, mesh, axes, mean)

    return reduce_from


def _per_rank_groups(real):
    """moe_ffn that routes each rank's own tokens in groups cut from them,
    whether or not the reference's groups span ranks."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel.sharding import active_mesh

    def moe_ffn(x, p, cfg):
        return moe._moe_ffn(x, p, cfg, active_mesh())

    moe_ffn.param_axes = real.param_axes
    return moe_ffn


# fault -> (module, attribute, a function of the real attribute that
# returns the faulty one).
TRAIN_FAULTS = {
    "fsdp gradient reduce-scatter left out": (
        "ray_tpu_torch.parallel.collectives", "_reduce_scatter",
        lambda real: _no_reduce_scatter),
    "tp sum of activations left out": (
        "ray_tpu_torch.models.llama", "_tp_out", lambda real: lambda x: x),
    "tp sum of gradients left out": (
        "ray_tpu_torch.models.llama", "_tp_in", lambda real: lambda x: x),
    "pipeline ring shift left out": (
        "ray_tpu_torch.parallel.collectives", "ring_shift",
        lambda real: lambda x, mesh, axis: x),
    "last stage's outputs not summed over pp": (
        "ray_tpu_torch.parallel.collectives", "reduce_from", _no_pp_sum),
    "tp max of the int8 scale left out": (
        "ray_tpu_torch.parallel.collectives", "all_max",
        lambda real: lambda x, mesh, axes: x.detach()),
    "MoE routing in per-rank groups": (
        "ray_tpu_torch.models.moe", "moe_ffn", _per_rank_groups),
}
# (run, fault or None): phase 8b's runs (chip_smoke.TWO_RANK_MESHES) and
# phase 9's (chip_smoke.rank_phase9). A fault is caught when one of its
# runs fails its phase's limits; every sound run must pass them.
TRAIN_RUNS = (
    ("fsdp=2", None), ("fsdp=2", "fsdp gradient reduce-scatter left out"),
    ("tp=2", None), ("tp=2", "tp sum of activations left out"),
    ("tp=2", "tp sum of gradients left out"),
    ("pipeline", None), ("pipeline", "pipeline ring shift left out"),
    ("pipeline", "last stage's outputs not summed over pp"),
    ("tp=2 ffn8", None), ("tp=2 ffn8", "tp max of the int8 scale left out"),
    ("moe sp=2", None), ("moe sp=2", "MoE routing in per-rank groups"),
    ("sp=2", None), ("multislice fsdp=2", None),
)


def _train_runs(seed):
    """On one rank: each of TRAIN_RUNS, the fault patched in for its run
    only."""
    out = {}
    for name, fault in TRAIN_RUNS:
        patch = contextlib.nullcontext()
        if fault:
            mod, attr, make = TRAIN_FAULTS[fault]
            mod = importlib.import_module(mod)
            patch = _patched(mod, attr, make(getattr(mod, attr)))
        with patch:
            if name in cs.TWO_RANK_MESHES:
                out[name, fault] = cs.rank_train(seed,
                                                 cs.TWO_RANK_MESHES[name])
            else:
                out[name, fault] = cs.rank_phase9(seed, name)
    return out


@contextlib.contextmanager
def _patched(mod, attr, fn):
    real = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def _phase8b_readings(r, single):
    loss_rel = [cs._rel(a, b) for a, b in zip(r["losses"], single["losses"])]
    norm_rel = [cs._rel(a, b) for a, b in zip(r["norms"], single["norms"])]
    ok = (max(loss_rel) <= cs.TWO_RANK_LOSS_REL
          and max(norm_rel) <= cs.TWO_RANK_NORM_REL)
    return (f"losses {r['losses']}, grad_norms {r['norms']}; relative to "
            f"one process, loss " + ", ".join(f"{x:.3e}" for x in loss_rel)
            + f" (limit {cs.TWO_RANK_LOSS_REL}), gradient norm "
            + ", ".join(f"{x:.3e}" for x in norm_rel)
            + f" (limit {cs.TWO_RANK_NORM_REL})"), ok


def train_faults(seed=0) -> int:
    single = {"bench": cs.rank_train(seed, None)}
    print(f"one process, no warm-up: losses {single['bench']['losses']}, "
          f"grad_norms {single['bench']['norms']}", flush=True)
    single["sp=2"] = single["multislice fsdp=2"] = single["bench"]
    for name in ("pipeline", "tp=2 ffn8", "moe sp=2"):
        single[name] = cs.phase9_single(seed, name)
        print(f"one process, {name}: "
              + ", ".join(f"{k} {v}" for k, v in single[name].items()
                          if k in ("loss", "losses", "aux", "norms")),
              flush=True)
    ranks = cs.run_ranks(_train_runs, (seed,), world=2, backend="gloo",
                         timeout=2400)
    caught = {fault: False for fault in TRAIN_FAULTS}
    bad = []
    for key in TRAIN_RUNS:
        name, fault = key
        oks = []
        for i, rank in enumerate(ranks):
            if name in cs.TWO_RANK_MESHES:
                text, ok = _phase8b_readings(rank[key], single["bench"])
            else:
                text, ok = cs.phase9_readings(name, rank[key],
                                              single.get(name))
            oks.append(ok)
            print(f"{name} {fault or 'sound'}, rank {i}: {text} "
                  + ("passes" if ok else "fails"), flush=True)
        if fault:
            caught[fault] = caught[fault] or not all(oks)
        elif not all(oks):
            bad.append(f"{name} sound")
    bad += [f"{fault} passes every limit" for fault, c in caught.items()
            if not c]
    flat, multi = (ranks[0][k, None]["losses"][0]
                   for k in ("fsdp=2", "multislice fsdp=2"))
    print(f"step 0 loss, flat fsdp=2 {flat!r}, multislice {multi!r}: "
          + ("equal" if flat == multi else "differ"))
    if flat != multi:
        bad.append("multislice fsdp=2 step 0")
    if bad:
        print(f"wrong side of the limits: {bad}")
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("gloo", "kernel-faults",
                                     "train-faults", "nccl",
                                     "nccl-ranks", "nccl-train"))
    what = ap.parse_args().what
    if not torch.cuda.is_available():
        print("sharded_chip: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    return {"gloo": gloo, "kernel-faults": kernel_faults,
            "train-faults": train_faults, "nccl": nccl,
            "nccl-ranks": nccl_ranks, "nccl-train": nccl_train}[what]()


if __name__ == "__main__":
    sys.exit(main())
