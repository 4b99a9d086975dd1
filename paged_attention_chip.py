#!/usr/bin/env python3
"""Two measurements of the paged attention kernel (P1) on one NVIDIA GPU.

    python3 paged_attention_chip.py splits    # time against pages_per_split
    python3 paged_attention_chip.py mutants   # planted faults vs the limits

``splits`` times P1 (CUDA events, L2 flushed, the stream held while the
host issues the call) at the main path's shapes for each pages_per_split
in a range, the wrapper's own choice marked with ``*``. ``mutants``
compiles three faulty copies of ``ray_tpu_torch/csrc/paged_attention.cu``
in a temporary directory (a split dropped from the combine, page 1 of every
split left out, the exp(m_s - M) rescale left out), swaps each in through
the wrapper's ``_kernel`` and checks that it fails chip_smoke.py's bf16
limits against ``paged_attention_split_reference``, at llama3_8b's heads
(32 / 8 of 128) and at mini's (12 / 4 of 64, with padded rows); it exits
non-zero if a fault passes at either head size. The sources in the checkout are never changed. Both exit 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

FIRST_STEP = [20, 63, 64, 65, 200, 511, 900, 1500]  # phase 2's prompts
BATCH64 = np.random.default_rng(1).integers(1, 2000, size=64).tolist()
WEIGHT = "const float w = expf(__ldcg(ml + (s * R + r) * 2) - mx);"
FAULTS = {
    "split 1 dropped from the combine": (
        WEIGHT, WEIGHT.replace("= expf", "= s == 1 ? 0.f : expf")),
    "page 1 of every split left out": (
        "const float p = expf(sc[bi][v] - mn);",
        "const float p = t == 1 ? 0.f : expf(sc[bi][v] - mn);"),
    "no exp(m_s - M) rescale": (WEIGHT, "const float w = 1.f;"),
}


def _module():
    # ray_tpu_torch.ops re-exports the function under the module's name.
    return importlib.import_module("ray_tpu_torch.ops.paged_attention")


def splits() -> int:
    pa = _module()
    choose = pa.pages_per_split
    shapes = [("B=8 K=1, first decode step", FIRST_STEP, 1, 32),
              ("B=8 K=4, first verify step", FIRST_STEP, 4, 32),
              ("B=64 K=1", BATCH64, 1, 32),
              ("B=4 K=1, 16k tokens", [16383, 9000, 4097, 12345], 1, 256)]
    for label, pos, kq, max_pages in shapes:
        args = cs.paged_case(len(pos), kq, pos, max_pages, torch.bfloat16,
                             seed=7, poison=False)
        own = pa.kernel_split(*args[:2], args[3])
        row = []
        for pps in sorted({1, 2, 4, 8, 16, max_pages, own}):
            # The wrapper's launch plan (cached per shape) reads the split
            # from pages_per_split: replace it and drop the cache.
            pa.pages_per_split = lambda *a, pps=pps: pps
            pa._launch_plan.cache_clear()
            assert pa.kernel_split(*args[:2], args[3]) == pps
            ms = cs.time_ms(lambda: pa.paged_attention(*args), iters=50,
                            warmup=5)
            row.append(f"{pps}{'*' if pps == own else ''}: {ms:.4f}")
        pa.pages_per_split = choose
        pa._launch_plan.cache_clear()
        print(f"{label}, ms by pages per split: " + "; ".join(row))
    return 0


def mutants() -> int:
    from ray_tpu_torch import _build

    pa = _module()
    src = (_build._CSRC / "paged_attention.cu").read_text()
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for i, (name, (good, bad)) in enumerate(FAULTS.items()):
        if src.count(good) != 1:
            raise SystemExit(f"{name}: the source line to plant it in moved")
        path = tmp / f"fault{i}.cu"
        path.write_text(src.replace(good, bad))
        lib = tmp / f"libfault{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
               "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    argtypes = pa._kernel().argtypes
    shapes = [("B=8 K=1 first decode step", 8, 1, FIRST_STEP, 32),
              ("B=8 K=4 first decode step", 8, 4, FIRST_STEP, 32),
              ("B=8 K=4 64 pages", 8, 4,
               [125, 126, 127, 253, 254, 255, 381, 3000], 64),
              ("B=4 K=1 16k tokens", 4, 1, [16383, 9000, 4097, 12345], 256),
              ("B=64 K=1", 64, 1, BATCH64, 32)]
    cases = [(f"D={heads[2]} {label}", *rest, heads)
             for heads in (cs.LLAMA8B_HEADS, cs.MINI_HEADS)
             for label, *rest in shapes]
    atol, rtol = cs.PAGED_BF16_TOL
    real, passed = pa._kernel, []
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(lib)).rtt_paged_attention
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        pa._kernel = lambda fn=fn: fn
        fails = {64: 0, 128: 0}
        for label, b, kq, pos, max_pages, (h, hkv, dh) in cases:
            args = cs.paged_case(b, kq, pos, max_pages, torch.bfloat16,
                                 seed=b + kq, n_heads=h, n_kv=hkv,
                                 head_dim=dh)
            got = pa.paged_attention(*args).float()
            want = pa.paged_attention_split_reference(
                *args, pa.kernel_split(*args[:2], args[3])).float()
            err = (got - want).abs()
            excess = float((err - rtol * want.abs()).max())
            rel = float(err.norm() / want.norm())
            bad = (not bool(torch.isfinite(got).all()) or excess > atol
                   or rel > cs.PAGED_BF16_NORM)
            fails[dh] += bad
            print(f"  {name} | {label}: beyond rtol {excess:.3e} (atol "
                  f"{atol}), norm-rel {rel:.3e} (limit "
                  f"{cs.PAGED_BF16_NORM}) {'fails' if bad else 'PASSES'}")
        pa._kernel = real
        for dh, n in fails.items():
            print(f"{name}: fails the limits in {n} of {len(shapes)} cases "
                  f"at head_dim {dh}")
            if not n:
                passed.append(f"{name} (head_dim {dh})")
    if passed:
        print(f"faults that pass the limits: {passed}")
    return 1 if passed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("splits", "mutants"))
    what = ap.parse_args().what
    if not torch.cuda.is_available():
        print("paged_attention_chip: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    return splits() if what == "splits" else mutants()


if __name__ == "__main__":
    sys.exit(main())
