"""Async distributed checkpoint subsystem.

Four pieces (see README "Checkpointing"):

- **Async snapshot-offload** (`AsyncCheckpointer`): ``save()`` pays only
  the device→host copy, a background thread persists + replicates +
  commits; ``wait()`` is the barrier.
- **Content-addressed shard store** (`store.ShardStore`): pytree leaves
  land as sha256-keyed chunks in the node object store, deduplicating
  unchanged state between consecutive checkpoints.
- **Peer replication**: each chunk is replicated to R-1 peer nodes over
  the object-transfer path; the head journals manifests + replica
  locations and a repair loop re-replicates on node death/drain.
- **Elastic resharded restore** (`restore` / `restore_uri`): leaves are
  assembled from surviving replicas and re-placed onto the current mesh
  via ``shardings=`` — no shared filesystem required.
"""

from ray_tpu_torch.checkpoint.fork import fork, fork_shares_chunks
from ray_tpu_torch.checkpoint.restore import (
    latest_step,
    list_checkpoints,
    restore,
    restore_uri,
)
from ray_tpu_torch.checkpoint.saver import (
    AsyncCheckpointer,
    take_step_stall_seconds,
    wait_pending,
)
from ray_tpu_torch.checkpoint.store import (
    CKPT_URI_PREFIX,
    ShardStore,
    is_ckpt_uri,
    make_uri,
    parse_uri,
)

__all__ = [
    "AsyncCheckpointer",
    "CKPT_URI_PREFIX",
    "ShardStore",
    "fork",
    "fork_shares_chunks",
    "is_ckpt_uri",
    "latest_step",
    "list_checkpoints",
    "make_uri",
    "parse_uri",
    "restore",
    "restore_uri",
    "take_step_stall_seconds",
    "wait_pending",
]
