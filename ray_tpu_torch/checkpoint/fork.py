"""Checkpoint lineage fork — the PBT exploit primitive.

A fork re-commits a complete checkpoint's per-rank manifests under a
new run name on the head (``ckpt_fork`` RPC). Chunks are
content-addressed, so the fork moves ZERO bulk bytes: both runs'
manifests reference the same sha256 chunk hashes, the location table
already covers them, and the GC refcount protects them as long as
either lineage retains the step. A PBT exploit is therefore "copy the
winner's manifest, perturb the hyperparameters" — cost independent of
model size.

``fork_shares_chunks`` is the dedup assertion the bench and tests pin:
it verifies the forked manifest's chunk set is EXACTLY the source's
(ratio 1.0 shared, 0 new).
"""

from __future__ import annotations

import ray_tpu_torch


def fork(run: str, new_run: str, step: int | None = None) -> dict:
    """Fork ``run``'s newest complete checkpoint (or ``step``) into
    ``new_run``. Returns the head's reply: ``{"ok", "run", "step",
    "ranks", "chunks", "new_bytes"}`` — ``new_bytes`` is 0 by
    construction. Raises ValueError when the source has no complete
    checkpoint."""
    rt = ray_tpu_torch.api._runtime
    reply = rt.run(
        rt.core.head.call("ckpt_fork", run=run, new_run=new_run, step=step)
    )
    if not reply.get("ok"):
        raise ValueError(reply.get("error", "checkpoint fork failed"))
    return reply


def _manifest_chunk_set(run: str, step: int) -> set[str]:
    from ray_tpu_torch.checkpoint.manifest import manifest_chunks

    rt = ray_tpu_torch.api._runtime
    reply = rt.run(rt.core.head.call("ckpt_manifest", run=run, step=step))
    return manifest_chunks(reply.get("entries") or {})


def fork_shares_chunks(run: str, new_run: str, step: int) -> dict:
    """Dedup accounting for a completed fork: compares the two runs'
    manifests at ``step``. Returns ``{"src_chunks", "dst_chunks",
    "shared", "new_chunks", "dedup_ratio"}`` where ``dedup_ratio`` is
    shared/dst (1.0 = the fork introduced nothing)."""
    src = _manifest_chunk_set(run, step)
    dst = _manifest_chunk_set(new_run, step)
    shared = src & dst
    return {
        "src_chunks": len(src),
        "dst_chunks": len(dst),
        "shared": len(shared),
        "new_chunks": len(dst - src),
        "dedup_ratio": (len(shared) / len(dst)) if dst else 1.0,
    }
