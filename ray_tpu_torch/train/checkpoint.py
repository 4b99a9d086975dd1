"""Checkpoints of the train state on one device (port of
ray_tpu/train/checkpoint.py).

A checkpoint is a directory: ``state.pt`` (``torch.save`` of the state's
named tensors, read back with ``torch.load(weights_only=True)``) and
``metadata.json``. Where the reference writes orbax shards of a sharded
pytree, the port saves a :class:`TrainState` through ``train_state_dict``
or a nested dict of tensors and numbers as it is.

Crash safety is the reference's: a save lands in ``<path>.tmp`` and is
swapped in with two renames (the previous copy goes to ``<path>.old``
first), so a preemption mid-save never destroys the previous copy, and a
crash between the renames is undone by :func:`_recover_interrupted_swap`.

The in-cluster shard store (``store_run``) and saving from several
processes need the runtime, which is not ported (ROADMAP.md, Queue 1 item
5): asking for either raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any

import torch

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
STATE_FILE = "state.pt"
_RUNTIME = "ROADMAP.md, Queue 1 item 5 (modules bound to the runtime)"


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


def _single_process() -> None:
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "checkpoints from several processes are not ported yet "
            f"({_RUNTIME})"
        )


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
    directory ``path``; returns its absolute path. The file is synced to
    disk before the swap."""
    _single_process()
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    old = f"{path}.old"
    _recover_interrupted_swap(path)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    kind, tensors = _named_tensors(state)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save({"kind": kind, "tensors": tensors}, f)
        f.flush()
        os.fsync(f.fileno())
    if metadata is not None:
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(metadata, f)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
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
    """Restore the state saved at ``path``.

    With ``target`` (a TrainState or dict like the one saved), every leaf
    must have the target's name, shape and dtype, or this raises: nothing
    is cast. Leaves go to the target's devices (or to ``device``), and
    keep the target's ``requires_grad``. Without a target they go to
    ``device`` (default "cuda"); a TrainState comes back as one, with
    parameters requiring grad."""
    path = os.path.abspath(path)
    _recover_interrupted_swap(path)
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    kind, tensors = payload["kind"], payload["tensors"]
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
        out[key] = t.to(dev or w.device)
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
    deleted, since it is the resume point."""

    def __init__(
        self,
        directory: str,
        *,
        num_to_keep: int = 2,
        score_attribute: str | None = None,
        score_order: str = "max",
        store_run: str | None = None,
    ):
        if store_run is not None:
            raise NotImplementedError(
                f"CheckpointManager(store_run=...): the in-cluster shard "
                f"store is not ported yet ({_RUNTIME})"
            )
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
        return None

    def best(self) -> str | None:
        entries = self._entries()
        if not entries:
            return None
        if self.score_attribute is None:
            return os.path.join(self.dir, entries[-1][1])
        name = max((n for _, n in entries), key=self._score)
        return os.path.join(self.dir, name)
