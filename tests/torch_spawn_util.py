"""Run a function on N ranks of a gloo process group, each in a fresh
spawned process, for the port's multi-process CPU tests.

The rendezvous is a file under the caller's temporary directory (never a
TCP port: several test workers run at once). Each rank returns a
picklable result; a rank that raises sends its traceback instead, and
the call raises it. The whole run has a hard time limit: on expiry every
child is killed and the call raises, so a hung collective fails its test
instead of stalling the suite.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback


def _entry(fn, rank, world, init, results, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # report to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_dir, *args, timeout: float = 120.0):
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; returns their
    results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(str(tmp_dir), "rendezvous")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, init, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise TimeoutError(
                    f"{fn.__name__}: {world - len(out)} of {world} ranks "
                    f"gave no result within {timeout:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                                   f"{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
