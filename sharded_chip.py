#!/usr/bin/env python3
"""Measurements behind chip_smoke.py's phase 8 (the sharded path) on one
NVIDIA GPU.

    python3 sharded_chip.py gloo           # which gloo collectives carry CUDA tensors
    python3 sharded_chip.py kernel-faults  # phase 8a's limits: sound and planted readings
    python3 sharded_chip.py train-faults   # phase 8b's limits: sound and planted readings

``gloo`` runs each collective in a fresh pair of processes (rank 0 and
rank 1 on cuda:0, a gloo process group over a ``file://`` rendezvous), so
one that aborts its process does not hide the others, and prints "ok" with
the values rank 0 saw, or the exit codes and the last line the ranks wrote
to standard error. ray_tpu_torch/parallel/collectives.py copies CUDA
tensors through host memory for a point-to-point send on a gloo group;
this is the record of why.

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
import importlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

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
    ranks = cs.run_two_ranks(_train_runs, (seed,), timeout=2400)
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
                                     "train-faults"))
    what = ap.parse_args().what
    if not torch.cuda.is_available():
        print("sharded_chip: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    return {"gloo": gloo, "kernel-faults": kernel_faults,
            "train-faults": train_faults}[what]()


if __name__ == "__main__":
    sys.exit(main())
