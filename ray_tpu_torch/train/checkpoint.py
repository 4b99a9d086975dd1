"""Checkpoints of the train state (port of ray_tpu/train/checkpoint.py).

A checkpoint is a directory: the state's named tensors and
``metadata.json``. Where the reference writes orbax shards of a sharded
pytree, the port saves a :class:`TrainState` through ``train_state_dict``
or a nested dict of tensors and numbers as it is. Every rank of the
process group (one, without a group) writes ``state.r<rank>.pt``
(``torch.save``, read back with ``torch.load(weights_only=True)``): the
windows it owns, its local shard of each DTensor (coordinate 0 of each
replicated mesh dimension) and, of the whole tensors, its round-robin
share by sorted name (checkpoint/manifest.py's rule); nothing is
gathered. A restore reads every rank's windows and places each tensor as
the target's is placed, so it may run on another mesh than the save.

Crash safety is the reference's: a save lands in ``<path>.tmp`` and is
swapped in with two renames (the previous copy goes to ``<path>.old``
first), so a preemption mid-save never destroys the previous copy, and a
crash between the renames is undone by :func:`_recover_interrupted_swap`.
Under several ranks the lead (rank 0) alone recovers, swaps and writes
the metadata; the others write their windows and wait for it at a
barrier, and a restore waits at a barrier before it reads.

``CheckpointManager(store_run=...)`` also saves into the in-cluster shard
store (``ray_tpu_torch.checkpoint.AsyncCheckpointer``, needs
``ray_tpu_torch.init``) and restores from it when no directory does.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
from typing import Any

import torch
import torch.distributed as dist

from ray_tpu_torch import resolve_device
from ray_tpu_torch.train.step import (
    TrainState,
    _flatten,
    _unflatten,
    train_state_dict,
    train_state_from_dict,
)

logger = logging.getLogger("ray_tpu_torch.train")

# The reference's naming: ckpt-NNNNNNNN; legacy checkpoint_NNNNNN
# directories are still found.
CKPT_DIR_PREFIX = "ckpt-"
_LEGACY_PREFIX = "checkpoint_"
STATE_FILE = "state.r{rank}.pt"  # one per rank


def checkpoint_dir_name(index: int) -> str:
    return f"{CKPT_DIR_PREFIX}{index:08d}"


def list_checkpoint_dirs(directory: str) -> list[tuple[int, str]]:
    """(index, name) for every checkpoint directory under ``directory``,
    current and legacy naming, sorted by index."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        for prefix in (CKPT_DIR_PREFIX, _LEGACY_PREFIX):
            if name.startswith(prefix):
                try:
                    out.append((int(name[len(prefix):]), name))
                except ValueError:
                    pass
                break
    return sorted(out)


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _owned_windows(tensors: dict[str, torch.Tensor], rank: int,
                   world: int) -> dict[str, list]:
    """{name: [(index, host tensor)]} this rank writes: every DTensor's
    local window, and the whole tensors it owns round-robin over the
    sorted names (checkpoint/manifest.py's partition)."""
    from ray_tpu_torch.checkpoint import manifest

    out = {}
    for i, name in enumerate(sorted(tensors)):
        t = tensors[name]
        if manifest._is_process_sharded(t) or i % world == rank:
            shards = manifest.local_shards(t)
            if shards:
                out[name] = [(idx, w.cpu()) for idx, w in shards]
    return out


def _assemble(path: str) -> tuple[str, dict[str, torch.Tensor]]:
    """(kind, whole tensors) from every rank's file under ``path``."""
    files = sorted(glob.glob(os.path.join(path,
                                          STATE_FILE.format(rank="*"))))
    if not files:
        raise FileNotFoundError(f"checkpoint {path}: no state file")
    payloads = [torch.load(f, map_location="cpu", weights_only=True)
                for f in files]
    world = payloads[0]["world"]
    if len(payloads) != world:
        raise ValueError(f"checkpoint {path}: {len(payloads)} of {world} "
                         "ranks' files")
    out = {}
    for name, (shape, dtype) in payloads[0]["shapes"].items():
        t = torch.empty(shape, dtype=getattr(torch, dtype))
        covered = 0
        for payload in payloads:
            for index, w in payload["windows"].get(name, ()):
                if index is None:
                    t.copy_(w)
                else:
                    t[tuple(slice(a, b) for a, b in index)] = w
                covered += w.numel()
        if covered != t.numel():
            raise ValueError(f"checkpoint {path}: {name}'s windows cover "
                             f"{covered} of {t.numel()} elements")
        out[name] = t
    return payloads[0]["kind"], out


def _place(t: torch.Tensor, like: torch.Tensor, device) -> torch.Tensor:
    """A whole host tensor placed as ``like``: cut to this rank's shard on
    a DTensor's mesh, else on ``device`` or ``like``'s device."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import distribute

    if isinstance(like, DTensor):
        return distribute(t.to(like.to_local().device), like.device_mesh,
                          like.placements)
    return t.to(device or like.device)


def _named_tensors(state: Any) -> tuple[str, dict[str, torch.Tensor]]:
    """("train_state", train_state_dict(state)) for a TrainState, else
    ("tree", leaves by "/"-joined path) for a nested dict of tensors and
    numbers."""
    if isinstance(state, TrainState):
        return "train_state", train_state_dict(state)
    if not isinstance(state, dict):
        raise TypeError(f"cannot checkpoint a {type(state).__name__}: pass "
                        "a TrainState or a dict of tensors")
    return "tree", {"/".join(path): torch.as_tensor(leaf).detach()
                    for path, leaf in _flatten(state)}


def save_checkpoint(path: str, state: Any,
                    metadata: dict | None = None) -> str:
    """Write ``state`` (a TrainState or a nested dict of tensors) to the
    directory ``path``; returns its absolute path. Under a process group
    of several ranks every rank calls this with the same ``path`` (on a
    filesystem they share) and returns once the lead has swapped the
    checkpoint in. The files are synced to disk before the swap."""
    rank, world = _rank_world()
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    old = f"{path}.old"
    if rank == 0:
        # Lead-only: a non-lead recovering concurrently with the lead's
        # two-rename swap would resurrect the old dir mid-swap.
        _recover_interrupted_swap(path)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    kind, tensors = _named_tensors(state)
    if world > 1:
        dist.barrier()  # the lead's fresh tmp dir exists
    payload = {
        "kind": kind, "world": world,
        "shapes": {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                   for k, t in tensors.items()},
        "windows": _owned_windows(tensors, rank, world),
    }
    with open(os.path.join(tmp, STATE_FILE.format(rank=rank)), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    if world > 1:
        dist.barrier()  # every rank's windows are on disk
    if rank == 0:
        if metadata is not None:
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    if world > 1:
        dist.barrier()  # the swap is done: every rank may read it
    return path


def _recover_interrupted_swap(path: str) -> None:
    """A crash between the two renames in save_checkpoint leaves the
    previous copy at ``<path>.old`` and nothing at ``path``; put it back."""
    old = f"{path}.old"
    if not os.path.exists(old):
        return
    if os.path.exists(path):
        # The crash came after the swap, before the cleanup.
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(old, path)


def restore_checkpoint(path: str, target: Any = None,
                       device: str | torch.device | None = None) -> Any:
    """Restore the state saved at ``path`` (by one process or several).

    With ``target`` (a TrainState or dict like the one saved), every leaf
    must have the target's name, shape and dtype, or this raises: nothing
    is cast. Leaves go where the target's are (a DTensor target takes
    this rank's shard on its mesh; others go to ``device`` or the
    target's device), and keep the target's ``requires_grad``. Without a
    target they go to ``device`` (default "cuda") whole; a TrainState
    comes back as one, with parameters requiring grad. Under several
    ranks every rank calls this."""
    rank, world = _rank_world()
    path = os.path.abspath(path)
    if rank == 0:
        _recover_interrupted_swap(path)
    if world > 1:
        dist.barrier()  # non-leads never race the lead's recovery rename
    kind, tensors = _assemble(path)
    if target is None:
        dev = resolve_device(device or "cuda")
        tensors = {k: t.to(dev) for k, t in tensors.items()}
        if kind == "train_state":
            return train_state_from_dict(tensors)
        return _unflatten((tuple(k.split("/")), t)
                          for k, t in tensors.items())
    want_kind, want = _named_tensors(target)
    if kind != want_kind or tensors.keys() != want.keys():
        missing = sorted(want.keys() - tensors.keys())
        extra = sorted(tensors.keys() - want.keys())
        raise ValueError(
            f"checkpoint {path} holds a {kind} that does not match the "
            f"target {want_kind}: missing {missing[:5]}, extra {extra[:5]}"
        )
    dev = resolve_device(device) if device is not None else None
    out = {}
    for key, w in want.items():
        t = tensors[key]
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {t.dtype} {tuple(t.shape)}, "
                f"the target's {w.dtype} {tuple(w.shape)}"
            )
        out[key] = _place(t, w, dev)
    if kind == "train_state":
        restored = train_state_from_dict(out)
        for (_, p), (_, w) in zip(_flatten(restored.params),
                                  _flatten(target.params)):
            p.requires_grad_(w.requires_grad)
        return restored
    for key, w in want.items():
        out[key].requires_grad_(w.requires_grad)
    return _unflatten((tuple(k.split("/")), t) for k, t in out.items())


def load_metadata(path: str) -> dict:
    meta = os.path.join(path, "metadata.json")
    if not os.path.exists(meta):
        return {}
    with open(meta) as f:
        return json.load(f)


class CheckpointManager:
    """Keep the top K checkpoints under a directory, by step or by a
    metric (``score_attribute`` / ``score_order``); the latest is never
    deleted, since it is the resume point. With ``store_run`` every save
    also goes into the in-cluster shard store under that run name
    (asynchronously: :class:`~ray_tpu_torch.checkpoint.AsyncCheckpointer`),
    and :meth:`restore_latest_valid` falls back to the store when no
    directory restores (a cluster without shared storage still
    resumes). Under several ranks every rank calls :meth:`save`; the lead
    prunes."""

    def __init__(
        self,
        directory: str,
        *,
        num_to_keep: int = 2,
        score_attribute: str | None = None,
        score_order: str = "max",
        store_run: str | None = None,
    ):
        self.store_run = store_run
        self._store = None
        if store_run is not None:
            from ray_tpu_torch.checkpoint import AsyncCheckpointer, saver

            saver._runtime()  # raises without ray_tpu_torch.init
            rank, world = _rank_world()
            self._store = AsyncCheckpointer(run=store_run, rank=rank,
                                            world=world)
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order

    def _entries(self) -> list[tuple[int, str]]:
        # A save that crashed mid-swap is recovered first, so latest() and
        # best() never skip it.
        for name in os.listdir(self.dir):
            if name.endswith(".old"):
                _recover_interrupted_swap(
                    os.path.join(self.dir, name[: -len(".old")])
                )
        return list_checkpoint_dirs(self.dir)

    def save(self, step: int, state: Any, metrics: dict | None = None) -> str:
        path = os.path.join(self.dir, checkpoint_dir_name(step))
        save_checkpoint(
            path, state, metadata={"step": step, "metrics": metrics or {}}
        )
        if self._store is not None:
            self._store.save(step, state, metrics)
        if _rank_world()[0] == 0:
            self._prune()
        return path

    def _score(self, name: str) -> float:
        meta = load_metadata(os.path.join(self.dir, name))
        val = meta.get("metrics", {}).get(self.score_attribute)
        if val is None:
            return float("-inf")
        return val if self.score_order == "max" else -val

    def _prune(self):
        entries = self._entries()
        if len(entries) <= self.num_to_keep:
            return
        if self.score_attribute is None:
            victims = entries[: len(entries) - self.num_to_keep]
        else:
            # The best-scoring K, but never the latest.
            latest = entries[-1][1]
            ranked = sorted(
                (name for _, name in entries if name != latest),
                key=self._score,
                reverse=True,
            )
            keep = set(ranked[: self.num_to_keep - 1]) | {latest}
            victims = [(s, n) for s, n in entries if n not in keep]
        for _, name in victims:
            shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def latest(self) -> str | None:
        entries = self._entries()
        return os.path.join(self.dir, entries[-1][1]) if entries else None

    def restore_latest_valid(
        self, target: Any = None, device: str | torch.device | None = None
    ) -> tuple[str, Any] | None:
        """Restore the newest checkpoint that loads: a partial or corrupt
        one costs one entry, not the run (the next-older entry is tried).
        Returns ``(path, state)``, or None when nothing restores."""
        for _step, name in reversed(self._entries()):
            path = os.path.join(self.dir, name)
            try:
                return path, restore_checkpoint(path, target=target,
                                                device=device)
            # Any load failure of this entry (a missing or truncated file,
            # a shape the target does not take): try the next-older one.
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "checkpoint %s failed to restore (%r); falling back "
                    "to the previous one", name, e,
                )
        if self._store is not None:
            # No directory restored (or none exists): the shard store.
            from ray_tpu_torch import checkpoint as dist_ckpt

            try:
                self._store.wait()
                step = dist_ckpt.latest_step(self.store_run)
                if step is not None:
                    state = dist_ckpt.restore(self.store_run, step,
                                              target=target)
                    return dist_ckpt.make_uri(self.store_run, step), state
            # The store degraded: behave like no checkpoint found.
            except Exception as e:  # noqa: BLE001
                logger.warning("shard-store restore for run %r failed: %r",
                               self.store_run, e)
        return None

    def best(self) -> str | None:
        entries = self._entries()
        if not entries:
            return None
        if self.score_attribute is None:
            return os.path.join(self.dir, entries[-1][1])
        name = max((n for _, n in entries), key=self._score)
        return os.path.join(self.dir, name)
