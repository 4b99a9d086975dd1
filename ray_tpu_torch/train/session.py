"""Per-worker training session: get_context() / report() from inside the
user's train loop (reference: ray.train.report and
ray.train.get_context(), python/ray/train/v2/_internal/execution/context).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TrainContext:
    world_size: int = 1
    rank: int = 0
    experiment_name: str = "default"
    storage_path: str = ""
    latest_checkpoint: str | None = None
    config: dict = field(default_factory=dict)
    # name → list of block ObjectRefs (this worker's split)
    dataset_shards: dict = field(default_factory=dict)
    # eager-collective group formed by the trainer backend (empty when
    # ScalingConfig.distributed is off); attempt-scoped name
    collective_group: str = ""
    # controller retry attempt this worker belongs to (0 on the first
    # try) — lets a train loop scope its own collective-group names per
    # attempt so a retry never rendezvouses with a dead attempt's KV keys
    attempt: int = 0
    # Straggler-tolerant gradient sync (ScalingConfig.allow_partial_grads
    # threads these through): partial_collective_opts() turns them into
    # the allreduce(min_ranks=, grace_s=) kwargs for the train loop.
    allow_partial_grads: bool = False
    partial_min_fraction: float = 0.75
    partial_grace_s: float | None = None
    # Compressed gradient sync (ScalingConfig.grad_compression): the
    # codec name grad_sync_opts() forwards to the gradient collective
    # ("int8" = block-scaled int8 wire format, fp32 accumulation).
    grad_compression: str | None = None
    # Bucketed overlap gradient sync (ScalingConfig.grad_overlap /
    # grad_bucket_mb / grad_error_feedback): grad_sync_opts() reports
    # overlap=True and grad_bucketer() hands the loop a configured
    # collective.bucketer.GradBucketer (cached per attempt).
    grad_overlap: bool = False
    grad_bucket_mb: float | None = None
    grad_error_feedback: bool = False
    _grad_bucketer: object = None
    # ZeRO-sharded weight update (ScalingConfig.zero_sharding,
    # arXiv:2004.13336): grad_sync_opts() reports zero=True and the
    # step loop flips from allreduce-then-full-update to
    # reduce-scatter → zero_optimizer().apply → allgather weights,
    # holding ~1/world of the optimizer state resident per rank.
    zero_sharding: bool = False
    _zero_optimizer: object = None
    # This worker's node "slice" label (None off-slice): the fault
    # domain it dies with. Resolved by TrainWorker.setup through the
    # head node table; the RAY_TPU_SLICE_FAIL chaos knob and slice-
    # aware train loops read it via train.slice_label().
    slice_label: str | None = None
    # Sweep-engine trial scoping (tune/sweep.py): the sweep and trial
    # this worker's gang belongs to (None outside a sweep). Threaded
    # from RunConfig through the backend env so a migrated gang keeps
    # its identity across attempts and nodes.
    sweep_id: str | None = None
    trial_id: str | None = None
    # mutated by report():
    reports: list = field(default_factory=list)
    latest_metrics: dict = field(default_factory=dict)
    # step-telemetry bookkeeping (train/telemetry.py): set by the
    # trainer at loop start / mutated as steps close
    _loop_start_wall: float | None = None
    _last_report_wall: float | None = None
    _last_checkpoint_s: float = 0.0
    _step_index: int = 0
    _used_step_timer: bool = False
    # skipped-rank fractions of this step's partial collectives; drained
    # into the step span's degraded_frac by telemetry at step close
    _partial_fracs: list = field(default_factory=list)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank


_context: TrainContext | None = None


def _set_context(ctx: TrainContext | None):
    global _context
    _context = ctx


def get_context() -> TrainContext:
    if _context is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() is only valid inside a train loop"
        )
    return _context


def collective_group_name() -> str:
    """Name of the worker group's eager collective group (initialized by
    the trainer when ScalingConfig(distributed=True)); pass to
    ray_tpu_torch.collective verbs inside the train loop."""
    name = get_context().collective_group
    if not name:
        raise RuntimeError(
            "no collective group: the trainer was not started with "
            "ScalingConfig(distributed=True)"
        )
    return name


def get_checkpoint() -> str | None:
    """Latest checkpoint directory to restore from (None on fresh start)."""
    return get_context().latest_checkpoint


def partial_collective_opts(world: int | None = None) -> dict:
    """The ``allreduce(min_ranks=, grace_s=)`` kwargs this worker group
    was configured for (``ScalingConfig(allow_partial_grads=True,
    partial_min_fraction=, partial_grace_s=)``), or ``{}`` when partial
    gradient sync is off — so train loops can write
    ``col.allreduce(grads, **train.partial_collective_opts())``
    unconditionally. ``world`` defaults to the worker-group size; pass
    the collective group's world when they differ."""
    import math

    ctx = get_context()
    if not ctx.allow_partial_grads:
        return {}
    n = world if world is not None else ctx.world_size
    return {
        "min_ranks": max(1, min(n, math.ceil(n * ctx.partial_min_fraction))),
        "grace_s": ctx.partial_grace_s,
    }


def grad_sync_opts(world: int | None = None) -> dict:
    """All gradient-sync kwargs this worker group was configured for —
    the partial K-of-N opts (``allow_partial_grads``) merged with the
    compression codec (``grad_compression``) — so train loops can write
    ``col.allreduce(grads, **train.grad_sync_opts())`` unconditionally
    and pick up both knobs. ``{}`` when neither is configured (the
    collective then runs its classic byte-identical path).

    With ``ScalingConfig(grad_overlap=True)`` the dict additionally
    carries ``overlap: True`` (plus ``bucket_bytes`` and
    ``error_feedback`` when configured). ``overlap`` is NOT an
    allreduce kwarg — it is the step loop's signal to switch to the
    bucketed async path::

        opts = train.grad_sync_opts()
        if opts.pop("overlap", False):
            pending = train.grad_bucketer().sync_async(grads)
            ...                      # remaining backward / other compute
            grads = train.grad_bucketer().unflatten(
                grads, pending.wait())   # join just before the update
        else:
            grads = col.allreduce(grads, **opts)
    """
    opts = partial_collective_opts(world)
    ctx = get_context()
    if ctx.grad_compression:
        opts["compression"] = ctx.grad_compression
    if ctx.grad_overlap:
        opts["overlap"] = True
        if ctx.grad_bucket_mb is not None:
            opts["bucket_bytes"] = int(ctx.grad_bucket_mb * (1 << 20))
        if ctx.grad_error_feedback:
            opts["error_feedback"] = True
    if ctx.zero_sharding:
        # Like "overlap", "zero" is the step loop's signal, not an
        # allreduce kwarg: pop it and switch to the sharded dataplane
        # (grad_bucketer().sync_sharded_async + zero_optimizer()).
        opts["zero"] = True
    return opts


def zero_optimizer(optimizer=None, params=None):
    """The cached :class:`~ray_tpu_torch.train.zero.ZeroOptimizer` for this
    worker group's ZeRO-sharded weight update
    (``ScalingConfig(zero_sharding=True)``). The first call must pass
    ``optimizer=`` and ``params=`` (shard-local state is initialized
    from them, claiming ~1/world of the adamw bytes in the HBM
    ledger); later calls return the cache — and, when ``params`` is
    given and the context's (rank, world) moved under it (elastic
    reform inside one process), repartition deterministically, closing
    the stale shard's memory claim."""
    ctx = get_context()
    if not ctx.zero_sharding:
        raise RuntimeError(
            "zero sharding is off: start the trainer with "
            "ScalingConfig(zero_sharding=True)"
        )
    cached = ctx._zero_optimizer
    if cached is not None:
        if params is not None and (
            cached.world != ctx.world_size or cached.rank != ctx.rank
        ):
            cached.repartition(ctx.rank, ctx.world_size, params)
        return cached
    if optimizer is None or params is None:
        raise RuntimeError(
            "first zero_optimizer() call must pass optimizer= and "
            "params= to initialize the shard-local state"
        )
    from ray_tpu_torch.train.zero import ZeroOptimizer

    ctx._zero_optimizer = ZeroOptimizer(
        optimizer, params, ctx.rank, ctx.world_size
    )
    return ctx._zero_optimizer


def grad_bucketer(group_name: str | None = None, world: int | None = None):
    """The configured :class:`~ray_tpu_torch.collective.bucketer.GradBucketer`
    for this worker group's bucketed overlap sync — every
    ``ScalingConfig`` gradient-sync knob applied (bucket size, int8
    codec + error feedback, partial K-of-N, per-bucket algo
    selection). Cached on the context: the error-feedback residuals
    must persist across steps. ``group_name`` defaults to the
    trainer's collective group."""
    ctx = get_context()
    gname = group_name or ctx.collective_group
    if not gname:
        raise RuntimeError(
            "no collective group for the gradient bucketer: pass "
            "group_name= or start the trainer with "
            "ScalingConfig(distributed=True)"
        )
    cached = ctx._grad_bucketer
    if cached is not None and cached.group_name == gname:
        return cached
    from ray_tpu_torch.collective.bucketer import GradBucketer

    popts = partial_collective_opts(world)
    ctx._grad_bucketer = GradBucketer(
        group_name=gname,
        bucket_bytes=(
            int(ctx.grad_bucket_mb * (1 << 20))
            if ctx.grad_bucket_mb is not None
            else None
        ),
        compression=ctx.grad_compression,
        min_ranks=popts.get("min_ranks"),
        grace_s=popts.get("grace_s"),
        error_feedback=ctx.grad_error_feedback,
    )
    return ctx._grad_bucketer


def slice_label() -> str | None:
    """This worker's node "slice" label (the fault domain it dies
    with), or None off-slice / when unresolved. Train loops use it to
    key slice-aware work (e.g. per-slice data shards) and the
    RAY_TPU_SLICE_FAIL chaos knob reads it to fail whole slices
    deterministically."""
    return get_context().slice_label


def note_partial_op(result) -> None:
    """Collective layer callback: a partial op skipped ranks under an
    active train session. The skipped fraction is charged to this step's
    ``degraded_frac`` (→ the head ledger's "degraded" category)."""
    ctx = _context
    if ctx is None:
        return
    ctx._partial_fracs.append(
        len(result.skipped) / max(1, result.world)
    )


def _own_node_notice() -> dict | None:
    """Drain notice for THIS worker's node (the one whose death this
    process will not survive), or None."""
    from ray_tpu_torch.runtime import drain

    try:
        import ray_tpu_torch.api as api

        core = getattr(api._runtime, "core", None)
        node_addr = getattr(core, "node_addr", None) if core else None
    # tpulint: allow(broad-except reason=drain-notice probe from a session that may have no runtime at all; None means no notice, which is the correct answer there)
    except Exception:  # noqa: BLE001 - session without a runtime
        node_addr = None
    return drain.for_node_addr(node_addr)


def preemption_notice() -> dict | None:
    """The active node-drain notice this train loop should react to, or
    None. Own-node notices win; otherwise ANY draining node's notice is
    returned so rank 0 can persist the emergency checkpoint for a peer
    whose node is about to die.

    The canonical loop pattern — checkpoint at the next step boundary
    inside the notice window, losing at most one step::

        ck = None
        if step % ckpt_every == 0 or train.preemption_notice():
            ck = save_my_state(...)
        train.report(metrics, checkpoint=ck)

    When this worker's OWN node is draining and a checkpoint was just
    handed to report(), report() raises :class:`PreemptedError` to
    unwind the attempt cleanly (toggle: RAY_TPU_TRAIN_EMERGENCY_
    CHECKPOINT)."""
    from ray_tpu_torch.runtime import drain

    return _own_node_notice() or drain.any_notice()


def get_dataset_shard(name: str = "train"):
    """This worker's split of a dataset passed to TorchTrainer(datasets=...)
    (reference: ray.train.get_dataset_shard → DataIterator). Returns a
    ray_tpu_torch.data Dataset over the shard's blocks; iterate with
    .iter_batches(batch_size=...).
    """
    ctx = get_context()
    refs = ctx.dataset_shards.get(name)
    if refs is None:
        raise KeyError(
            f"no dataset {name!r}; trainer got "
            f"{sorted(ctx.dataset_shards)}"
        )
    if isinstance(refs, dict) and "__token_dataset__" in refs:
        # Native token loader: re-open in this worker, sharded to rank.
        from ray_tpu_torch.train.dataloader import TokenDataset

        return TokenDataset.from_descriptor(
            refs, rank=refs.get("rank", 0), world=refs.get("world", 1)
        )
    from ray_tpu_torch.data.dataset import MaterializedDataset

    return MaterializedDataset(list(refs))


@contextlib.contextmanager
def step_span(
    flops: float | None = None,
    tokens: int | None = None,
    flops_per_token: float | None = None,
):
    """Wrap one training step for phase attribution, MFU, and goodput.

    ::

        with train.step_span(tokens=8192, flops_per_token=6 * n_params) as s:
            with s.phase("data_wait"):
                batch = next(it)
            with s.phase("compute"):
                state, m = train_step(state, batch)

    Phase durations feed the ``ray_tpu_train_step_phase_seconds``
    histogram and render as slices in ``ray_tpu_torch timeline``; the step's
    FLOP count (``flops``, or ``tokens * flops_per_token``) yields
    per-step MFU. Phases named ``data_wait`` / ``checkpoint`` count as
    lost time in the head's per-job goodput. A no-op outside a train
    session or with RAY_TPU_TRAIN_TELEMETRY=0; a step that raises emits
    nothing (its time surfaces as restart loss, not productive time)."""
    ctx = _context
    from ray_tpu_torch.train import telemetry

    if ctx is None or not telemetry.telemetry_enabled():
        yield telemetry.NOOP_STEP
        return
    if flops is None and tokens is not None and flops_per_token is not None:
        flops = tokens * flops_per_token
    timer = telemetry.StepTimer(flops)
    yield timer
    telemetry.finish_step(ctx, timer)


def report(metrics: dict, checkpoint: str | None = None) -> None:
    """Report metrics (all ranks) and optionally a checkpoint directory
    (rank 0's is persisted; reference: ray.train.report semantics)."""
    from ray_tpu_torch.checkpoint.store import is_ckpt_uri

    ctx = get_context()
    ctx.latest_metrics = dict(metrics)
    entry: dict[str, Any] = {"metrics": dict(metrics)}
    ctx._last_checkpoint_s = 0.0
    if checkpoint is not None and is_ckpt_uri(checkpoint):
        # In-cluster shard-store checkpoint: nothing to copy — the async
        # persist runs in the background. The goodput ledger charges only
        # the snapshot stall the save() paid on this step loop.
        from ray_tpu_torch.checkpoint import saver as _ckpt_saver

        entry["checkpoint"] = checkpoint
        ctx._last_checkpoint_s = _ckpt_saver.take_step_stall_seconds()
    elif checkpoint is not None and ctx.rank == 0:
        # Index continues from what's already persisted so a retry attempt
        # appends after the restored checkpoint instead of overwriting
        # earlier ones (which would make the newest-named dir stale).
        from ray_tpu_torch.train.checkpoint import (
            checkpoint_dir_name,
            list_checkpoint_dirs,
        )

        run_dir = os.path.join(ctx.storage_path, ctx.experiment_name)
        os.makedirs(run_dir, exist_ok=True)
        existing = [i for i, _name in list_checkpoint_dirs(run_dir)]
        idx = max(existing, default=-1) + 1
        dest = os.path.join(run_dir, checkpoint_dir_name(idx))
        ckpt_t0 = time.perf_counter()
        if os.path.abspath(checkpoint) != os.path.abspath(dest):
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(checkpoint, dest)
        ctx._last_checkpoint_s = time.perf_counter() - ckpt_t0
        entry["checkpoint"] = dest
    ctx.reports.append(entry)
    # Loops that never call train.step_span() still get goodput accounting:
    # each report() closes one implicit step (checkpoint copy included).
    from ray_tpu_torch.train import telemetry

    now = time.time()
    if not ctx._used_step_timer and telemetry.telemetry_enabled():
        telemetry.implicit_step(ctx, now, metrics)
    ctx._last_report_wall = now
    # Emergency-checkpoint unwind: this worker's node is DRAINING and the
    # loop just put a checkpoint in hand — end the attempt NOW, at a step
    # boundary, so the controller resizes and resumes losing ≤1 step
    # instead of whatever remained of the inter-checkpoint interval.
    # Raised AFTER the step/checkpoint is fully accounted (ledger-wise
    # the step that produced the emergency checkpoint is productive).
    if checkpoint is not None:
        from ray_tpu_torch._private import config

        if config.get("TRAIN_EMERGENCY_CHECKPOINT"):
            notice = _own_node_notice()
            if notice is not None:
                from ray_tpu_torch.exceptions import PreemptedError

                if is_ckpt_uri(checkpoint):
                    # The snapshot is already offloaded; the drain window
                    # pays only the persist — barrier it so the attempt
                    # never unwinds on an uncommitted manifest.
                    from ray_tpu_torch import checkpoint as _dist_ckpt

                    _dist_ckpt.wait_pending()
                raise PreemptedError(
                    node_id=notice.get("node_id"),
                    reason=notice.get("reason", ""),
                    deadline_ts=notice.get("deadline_ts"),
                )
