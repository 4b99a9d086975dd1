"""Declarative collective groups on actor handles (reference:
python/ray/experimental/collective/ — create_collective_group(actors)
used by the GPU-object transport; the imperative per-process API lives in
ray_tpu_torch.collective, mirroring python/ray/util/collective/collective.py).

The driver assigns ranks by actor order and tells every actor to join the
named group; actors rendezvous through the head's KV store (the
reference's NCCLUniqueID named-actor store pattern,
nccl_collective_group.py:29–56, replaced by head-KV rendezvous)."""

from __future__ import annotations

from typing import Sequence


def _group_init(instance, world: int, rank: int, backend, group_name: str,
                dist_backend: str = "nccl"):
    from ray_tpu_torch import collective

    collective.init_collective_group(
        world, rank, backend=backend, group_name=group_name,
        dist_backend=dist_backend,
    )
    return rank


def _group_destroy(instance, group_name: str):
    from ray_tpu_torch import collective

    if collective.is_group_initialized(group_name):
        collective.destroy_collective_group(group_name)
    return True


def _sys_call(handle, fn, *args):
    from ray_tpu_torch.api import _submit_system_task

    return _submit_system_task(handle, fn, *args)


def create_collective_group(
    actors: Sequence,
    backend: str = "cpu",
    group_name: str = "default",
    dist_backend: str = "nccl",
) -> None:
    """Join ``actors`` into one collective group; rank = position in the
    list. Blocks until every member has initialized. ``dist_backend`` is
    the process group's backend of a ``"nccl"`` group ("gloo" on
    request)."""
    import ray_tpu_torch

    world = len(actors)
    refs = [
        _sys_call(a, _group_init, world, rank, backend, group_name,
                  dist_backend)
        for rank, a in enumerate(actors)
    ]
    ray_tpu_torch.get(refs, timeout=60)


def destroy_collective_group(
    actors: Sequence, group_name: str = "default"
) -> None:
    import ray_tpu_torch

    refs = [_sys_call(a, _group_destroy, group_name) for a in actors]
    ray_tpu_torch.get(refs, timeout=60)
