# tpulint fixture: flow-sensitive rank divergence (TPU103).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
from ray_tpu_torch import collective as col


def _sync_all(grads):
    return col.allreduce(grads)


def _outer_helper(grads):
    return _sync_all(grads)  # issuer by transitivity (depth 2)


class Trainer:
    def _flush(self):
        col.barrier()

    def step(self, rank, grads):
        if rank == 0:
            _sync_all(grads)  # TPU103 @ line 20 (wrapped collective)
        if rank != 0:
            return None
        _outer_helper(grads)  # TPU103 @ line 23 (after early return)
        return grads

    def by_slice(self, slice_label, grads):
        if slice_label == "a":
            self._flush()  # TPU103 @ line 28 (slice-dependent helper)
        return grads
