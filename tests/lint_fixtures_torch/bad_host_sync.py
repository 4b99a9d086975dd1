"""TPU601 fixture: host syncs in hot regions.

Exact rule ids + lines are pinned in test_torch_lint.py.
"""
import torch
import numpy as np
import ray_tpu_torch.train as train


def step_loop_strong_sync(state, batches, step_fn):
    for batch in batches:
        with train.step_span() as sp:
            torch.cuda.synchronize()            # strong sync, step body
            with sp.phase("compute"):
                state, m = step_fn(state, batch)
        train.report({"loss": 1.0})


def compute_phase_weak_sync(state, batch, step_fn, grads):
    with train.step_span() as sp:
        with sp.phase("compute"):
            gnorm = float(np.sum(grads))        # weak sync, compute span
            state, m = step_fn(state, batch)
    return gnorm


def compute_phase_item(sp, metrics):
    with sp.phase("compute"):
        return metrics["loss"].item()           # .item() in compute span


def _probe(arr):
    return arr.cpu()


def transitive_helper_sync(sp, arr):
    with sp.phase("compute"):
        return _probe(arr)                      # reaches .cpu()
