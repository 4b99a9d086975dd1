# tpulint fixture: collective-divergence (TPU101 / TPU102).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
from ray_tpu_torch import collective as col
from ray_tpu_torch.collective import barrier


def rank_conditional(rank: int):
    if rank == 0:
        col.broadcast(1, src_rank=0)  # TPU101 @ line 9
    return rank


def rank_else_branch(world_rank: int):
    if world_rank == 0:
        pass
    else:
        barrier()  # TPU101 @ line 17 (else of a rank test diverges too)


def early_exit(rank: int, grad):
    if rank != 0:
        return None
    return col.allreduce(grad)  # TPU102 @ line 23


def symmetric_ok(grad):
    # Every rank reaches both ops: clean.
    out = col.allreduce(grad)
    col.barrier()
    return out


def pragma_ok(rank: int):
    if rank == 0:
        # tpulint: allow(collective-divergence reason=single-rank probe group of size 1)
        col.barrier(group_name="probe")
    return rank
