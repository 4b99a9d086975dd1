# tpulint fixture: dropped collective handle (TPU104).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
from ray_tpu_torch import collective as col


def discarded(grads):
    col.allreduce_async(grads)  # TPU104 @ line 7 (result discarded)
    return grads


def never_waited(g, grads, flag):
    h = g.allreduce_async(grads)  # TPU104 @ line 12 (no wait on a path)
    if flag:
        return h.wait()
    return grads


def overwritten(g, buckets):
    h = None
    for b in buckets:
        h = g.reducescatter_async(b)  # TPU104 @ line 21 (loop overwrite)
    return h.wait()
