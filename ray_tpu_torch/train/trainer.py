"""TorchTrainer: controller + worker-group training (Train v2 architecture).

The port of the JAX package's ``JaxTrainer``, which mirrors the
reference's Train v2 control plane (reference:
python/ray/train/v2/api/data_parallel_trainer.py:66 `fit` :154 →
TrainController controller.py:103 → WorkerGroup worker_group.py:112 on a
placement group → per-framework Backend.on_start; TorchTrainer's
process-group bootstrap, python/ray/train/torch/config.py). Here:

- The worker group reserves one placement-group bundle per worker; a
  GPU worker's bundle holds ``gpus_per_worker`` of the runtime's "GPU"
  resource, bound to cards of its own (fractions share a card), and the
  worker sees those cards only (``CUDA_VISIBLE_DEVICES``).
- With ``distributed=True`` each worker joins a NCCL collective group
  and a default ``torch.distributed`` process group, both rendezvoused
  through the head's KV store (``dist_backend``: "nccl", or "gloo"
  when asked for), so ``parallel/mesh.py::make_mesh`` spans the group.
  On NCCL a worker runs on ``cuda:0`` of its own view, its leased card.
- Failure policy: a slice is atomic — any worker death fails the whole
  attempt; the controller re-creates the group and restores from the
  latest checkpoint (reference: failure_policy.py RETRY semantics).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import logging

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.placement import placement_group, remove_placement_group
from ray_tpu_torch.train.session import TrainContext, _set_context

logger = logging.getLogger("ray_tpu_torch.train")


@dataclass
class ScalingConfig:
    """(reference: ray.train.ScalingConfig; the JAX package's TPU fields
    use_tpu/chips_per_worker become use_gpu/gpus_per_worker)"""

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 0
    resources_per_worker: dict = field(default_factory=dict)
    # A TPU slice's topology: no GPU counterpart, refused when set.
    topology: str | None = None
    placement_strategy: str = "PACK"
    # One process group across all workers: every worker joins a NCCL
    # collective group and a default torch.distributed group
    # (KV-rendezvous'd through the head) before the train loop, so
    # make_mesh spans the worker group (reference: TorchTrainer's
    # process-group setup per worker). Required for FSDP/TP across
    # processes; off for independent per-worker DP loops.
    distributed: bool = False
    # torch.distributed backend of those groups: "nccl" (one GPU per
    # rank), or "gloo" when asked for (CPU workers; several ranks on
    # one GPU, which NCCL refuses).
    dist_backend: str = "nccl"
    # Deadline for the worker group's collective ops and rendezvous
    # (None = config COLLECTIVE_TIMEOUT_S). A member lost mid-step then
    # surfaces as a typed collective abort within this bound, which the
    # controller turns into an elastic resize instead of a hang.
    collective_timeout_s: float | None = None
    # Straggler-tolerant gradient sync: with allow_partial_grads on, the
    # train loop's session.partial_collective_opts() maps to
    # allreduce(min_ranks=ceil(world * partial_min_fraction),
    # grace_s=partial_grace_s) — a slow host costs the step a bounded,
    # rescaled skip (charged to the goodput ledger as "degraded") instead
    # of stalling the world; chronic skips escalate into the
    # drain-and-replace path. partial_grace_s None = config
    # COLLECTIVE_PARTIAL_GRACE_S.
    allow_partial_grads: bool = False
    partial_min_fraction: float = 0.75
    partial_grace_s: float | None = None
    # Compressed gradient sync: grad_compression="int8" makes
    # session.grad_sync_opts() request the block-scaled int8 codec on
    # the gradient allreduce (~3.9x fewer wire bytes, fp32
    # accumulation — see ray_tpu_torch/collective/codec.py). Composes with
    # allow_partial_grads: the compressed program carries the partial
    # mask. None keeps gradient sync byte-identical to today.
    grad_compression: str | None = None
    # Bucketed overlap gradient sync (T3-style): with grad_overlap on,
    # session.grad_sync_opts() reports overlap=True and the step loop
    # issues per-bucket async allreduces (collective/bucketer.py)
    # eagerly — in reverse-layer order, ~grad_bucket_mb MiB per bucket
    # (None = config COLLECTIVE_BUCKET_MB), per-bucket ring/tree
    # selection by size — joining the handles just before the optimizer
    # update so the collectives hide behind remaining compute.
    # grad_error_feedback carries each bucket's int8 quantization
    # residual into the next step (needs grad_compression).
    grad_overlap: bool = False
    grad_bucket_mb: float | None = None
    grad_error_feedback: bool = False
    # ZeRO-sharded weight update (arXiv:2004.13336): with zero_sharding
    # on, session.grad_sync_opts() reports zero=True and the step loop
    # flips gradient sync from allreduce → full update on every rank to
    # reduce-scatter → shard-local optimizer update (train/zero.py,
    # ~1/world of the adamw state resident per rank — the BENCH_8B
    # capacity wall) → allgather updated weights. Leaf ownership is the
    # checkpoint manifest's round-robin partition, so saving the
    # sharded state via AsyncCheckpointer(local_prefixes=
    # (zero.CKPT_PREFIX,)) needs no gather. Composes with
    # grad_compression (+error feedback) and allow_partial_grads on
    # the reduce hop; the gather hop ships exact weights, all-N.
    zero_sharding: bool = False

    def __post_init__(self):
        if self.topology is not None:
            raise ValueError(
                "ScalingConfig(topology=...) names a TPU slice topology, "
                "which has no GPU counterpart"
            )

    def bundle(self) -> dict:
        b = {"CPU": 1.0}
        b.update(self.resources_per_worker)
        if self.use_gpu and self.gpus_per_worker:
            b["GPU"] = float(self.gpus_per_worker)
        return b


@dataclass
class FailureConfig:
    max_failures: int = 0


class ScalingPolicy:
    """Decides each attempt's worker-group size (reference:
    train/v2/_internal/execution/scaling_policy/scaling_policy.py).
    The default keeps the configured size: a failed attempt retries at
    full width. ``last_error`` carries the previous attempt's failure —
    a CollectiveError (member death / op timeout) is the resize trigger
    the collective layer surfaces to elastic policies."""

    def workers_for_attempt(
        self,
        scaling: "ScalingConfig",
        attempt: int,
        cluster_free: list[dict],
        last_error: Exception | None = None,
    ) -> int:
        del attempt, cluster_free, last_error
        return scaling.num_workers


class ElasticScalingPolicy(ScalingPolicy):
    """Re-fit the worker group to what the cluster can actually place.

    A slice is atomic — losing one host loses the whole slice — so
    after a failure the next attempt resizes to however many worker
    bundles still fit (floor min_workers), restoring from the latest
    checkpoint instead of waiting for the dead slice to come back
    (SURVEY.md §7 hard parts; reference resize semantics:
    scaling_policy.py + slice-atomic failure handling)."""

    def __init__(self, min_workers: int = 1):
        if min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        self.min_workers = min_workers

    def workers_for_attempt(
        self,
        scaling: "ScalingConfig",
        attempt: int,
        cluster_free: list[dict],
        last_error: Exception | None = None,
    ) -> int:
        del last_error  # any failure re-fits; the kind only affects settle
        if attempt == 0:
            return scaling.num_workers
        bundle = scaling.bundle()
        spread = scaling.placement_strategy in ("SPREAD", "STRICT_SPREAD")
        fit = 0
        for avail in cluster_free:
            # Slice-labeled nodes count by WHOLE SURVIVING SLICES, not
            # bundles: a slice with a draining/dead sibling is atomic —
            # its survivors die with it (GCE reaps the slice as a unit),
            # so bundles placed there would size an attempt that loses
            # them mid-rendezvous. _cluster_free marks members of such
            # slices with _slice_whole=False.
            if avail.get("_slice") is not None and not avail.get(
                "_slice_whole", True
            ):
                continue
            per_node = min(
                (
                    int(avail.get(k, 0.0) // v)
                    for k, v in bundle.items()
                    if v > 0
                ),
                default=0,
            )
            # STRICT_SPREAD needs a distinct node per bundle; counting
            # stacked bundles would size an infeasible attempt.
            fit += min(per_node, 1) if spread else per_node
        return max(self.min_workers, min(scaling.num_workers, fit))


@dataclass
class RunConfig:
    name: str = "train_run"
    storage_path: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "ray_tpu_results"))
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    # Sweep-engine trial scoping (tune/sweep.py sets these): carried
    # into every worker's TrainContext so telemetry and chaos tooling
    # can attribute a gang to its trial across migrations.
    sweep_id: str | None = None
    trial_id: str | None = None
    # Seed the resume path before the FIRST attempt: a checkpoint path
    # or ckpt:// URI, or "auto" to discover the run's newest valid
    # checkpoint (file dir or in-cluster shard store). "auto" is how a
    # PBT-forked trial restores the manifest forked into its run name.
    resume_from_checkpoint: str | None = None


@dataclass
class Result:
    metrics: dict
    checkpoint: str | None
    path: str
    error: Exception | None = None


def _init_default_process_group(name: str, world: int, rank: int,
                                backend: str, timeout_s: float | None):
    """The default torch.distributed process group of this worker, on a
    TCPStore that rank 0 publishes in the head's KV (what
    jax.distributed.initialize gives the JAX package's workers)."""
    import torch.distributed as dist

    from ray_tpu_torch.collective.backends.nccl_group import (
        bootstrap_distributed,
    )

    if dist.is_initialized():
        raise RuntimeError(
            "a default torch.distributed process group exists already in "
            "this worker"
        )
    rt = ray_tpu_torch.api._runtime
    store = rt.run(bootstrap_distributed(rt.core, name, world, rank,
                                         timeout_s))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def _bind_leased_cards(gpus_per_worker: float) -> None:
    """A NCCL rank runs on ``cuda:0`` of its own view. The node started
    this worker with ``CUDA_VISIBLE_DEVICES`` naming its lease's cards
    (runtime/node.py), so its first card is the leased one: check that
    the view holds exactly the cards the lease named, and make cuda:0
    this thread's device (a thread's current device is its own)."""
    import torch

    cards = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
             if c.strip()]
    if gpus_per_worker < 1 or len(cards) != int(gpus_per_worker):
        raise RuntimeError(
            f"a NCCL train worker needs whole cards of its own: "
            f"gpus_per_worker {gpus_per_worker}, CUDA_VISIBLE_DEVICES "
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r} (ScalingConfig("
            f"use_gpu=True, gpus_per_worker=1), or dist_backend='gloo' for "
            f"ranks that share a card)"
        )
    if torch.cuda.device_count() != len(cards):
        raise RuntimeError(
            f"CUDA shows {torch.cuda.device_count()} devices to a worker "
            f"leased cards {cards}"
        )
    torch.cuda.set_device(0)


@ray_tpu_torch.remote
class TrainWorker:
    """One member of the worker group (reference: worker_group.py actors)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.ctx: TrainContext | None = None

    def setup(
        self,
        experiment_name: str,
        storage_path: str,
        config: dict,
        latest_checkpoint: str | None,
        backend_env: dict,
        dataset_shards: dict | None = None,
    ):
        os.environ.update(backend_env)
        # Watch the head's drain fan-out (the PR-1 death channel): a
        # preemption notice for any node must reach this worker BEFORE
        # the node dies so the loop can take its emergency checkpoint
        # at the next step boundary (train.preemption_notice()).
        try:
            import ray_tpu_torch.collective as _col

            rt = ray_tpu_torch.api._runtime
            rt.run(_col._ensure_death_watch(rt.core))
        except Exception:  # noqa: BLE001 - client-mode / degraded head
            logger.debug(
                "drain fan-out subscription unavailable; training "
                "continues without the preemption notice window",
                exc_info=True,
            )
        collective_group = ""
        attempt = int(backend_env.get("RAY_TPU_TRAIN_ATTEMPT", "0"))
        col_timeout = backend_env.get("RAY_TPU_TRAIN_COLLECTIVE_TIMEOUT_S")
        col_timeout = float(col_timeout) if col_timeout else None
        if backend_env.get("RAY_TPU_TRAIN_DISTRIBUTED") == "1":
            # One process group across the worker group: a NCCL
            # collective group (session.collective_group_name()) and the
            # default torch.distributed group that make_mesh builds on,
            # both through the head-KV rendezvous BEFORE the train loop
            # (reference: TorchTrainer's per-worker
            # init_process_group). The name is ATTEMPT-scoped so a retry
            # never rendezvouses with a dead previous attempt's
            # coordinator KV entry.
            from ray_tpu_torch import collective as col

            dist_backend = backend_env.get("RAY_TPU_TRAIN_DIST_BACKEND",
                                           "nccl")
            if dist_backend == "nccl":
                _bind_leased_cards(float(backend_env.get(
                    "RAY_TPU_TRAIN_GPUS_PER_WORKER", "0")))
            collective_group = f"train:{experiment_name}:a{attempt}"
            if not col.is_group_initialized(collective_group):
                col.init_collective_group(
                    self.world_size,
                    self.rank,
                    backend=col.Backend.NCCL,
                    group_name=collective_group,
                    timeout_s=col_timeout,
                    dist_backend=dist_backend,
                )
            _init_default_process_group(
                f"{collective_group}:default", self.world_size, self.rank,
                dist_backend, col_timeout,
            )
        partial_grace = backend_env.get("RAY_TPU_TRAIN_PARTIAL_GRACE_S")
        grad_compression = (
            backend_env.get("RAY_TPU_TRAIN_GRAD_COMPRESSION") or None
        )
        grad_bucket_mb = backend_env.get("RAY_TPU_TRAIN_GRAD_BUCKET_MB")
        # The slice fault domain this worker dies with: its node's
        # "slice" label (None off-slice). Resolved once at setup so the
        # loop (and the SLICE_FAIL chaos knob) never pays a head RPC
        # per step.
        slice_label = None
        try:
            rt = ray_tpu_torch.api._runtime
            node_addr = getattr(rt.core, "node_addr", None)
            if node_addr:
                table = rt.run(rt.core.head.call("node_table"), 5)
                for n in table.values():
                    if n.get("addr") == node_addr:
                        slice_label = (n.get("labels") or {}).get("slice")
                        break
        # tpulint: allow(broad-except reason=client-mode / degraded head: a worker without a resolvable slice simply has no slice fault domain)
        except Exception:
            slice_label = None
        self.ctx = TrainContext(
            world_size=self.world_size,
            rank=self.rank,
            experiment_name=experiment_name,
            storage_path=storage_path,
            latest_checkpoint=latest_checkpoint,
            config=config,
            dataset_shards=dataset_shards or {},
            collective_group=collective_group,
            attempt=attempt,
            allow_partial_grads=(
                backend_env.get("RAY_TPU_TRAIN_PARTIAL_GRADS") == "1"
            ),
            partial_min_fraction=float(
                backend_env.get("RAY_TPU_TRAIN_PARTIAL_MIN_FRACTION", "0.75")
            ),
            partial_grace_s=float(partial_grace) if partial_grace else None,
            grad_compression=grad_compression,
            grad_overlap=(
                backend_env.get("RAY_TPU_TRAIN_GRAD_OVERLAP") == "1"
            ),
            grad_bucket_mb=(
                float(grad_bucket_mb) if grad_bucket_mb else None
            ),
            grad_error_feedback=(
                backend_env.get("RAY_TPU_TRAIN_GRAD_ERROR_FEEDBACK") == "1"
            ),
            zero_sharding=(
                backend_env.get("RAY_TPU_TRAIN_ZERO_SHARDING") == "1"
            ),
            slice_label=slice_label,
            sweep_id=backend_env.get("RAY_TPU_TRAIN_SWEEP_ID") or None,
            trial_id=backend_env.get("RAY_TPU_TRAIN_TRIAL_ID") or None,
        )
        return True

    def run_loop(self, train_loop: Callable, use_context_arg: bool):
        from ray_tpu_torch.util import tracing

        _set_context(self.ctx)
        # Anchor for the first implicit step (report() with no explicit
        # step_span) and for the attempt span below.
        attempt_start = time.time()
        self.ctx._loop_start_wall = attempt_start
        try:
            if use_context_arg:
                train_loop(self.ctx.config)
            else:
                train_loop()
        except Exception as e:
            # OOM forensics: a ResourceExhausted (real backend OOM or
            # the RAY_TPU_FAKE_HBM_GB injection) must answer "what ate
            # the HBM" before the attempt dies — ranked live-buffer
            # report as a mem:oom span + persisted JSON (idempotent:
            # the injection path may have already filed it).
            from ray_tpu_torch.runtime import memory as _mem

            if _mem.is_resource_exhausted(e):
                try:
                    _mem.on_resource_exhausted(
                        e, job=self.ctx.experiment_name
                    )
                # tpulint: allow(broad-except reason=forensics on an attempt that is already dying of OOM; the OOM is the error that must propagate)
                except Exception:  # noqa: BLE001
                    logger.debug("OOM forensics failed", exc_info=True)
            # Collective abort (a group member died / an op timed out
            # mid-step): tear down this worker's groups so their pending
            # futures fail instead of leaking, then fail the attempt —
            # the controller surfaces the abort to the scaling policy as
            # a resize trigger and restores from the last checkpoint.
            from ray_tpu_torch.collective.types import CollectiveError

            if isinstance(e, CollectiveError):
                import ray_tpu_torch.collective as col

                for name in list(col._groups):
                    try:
                        col.destroy_collective_group(name)
                    # tpulint: allow(broad-except reason=group teardown while the attempt is already failing on a collective abort; the original abort is the error that propagates)
                    except Exception:  # noqa: BLE001 - teardown best-effort
                        pass
            raise
        finally:
            _set_context(None)
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            # Attempt-end checkpoint barrier: an async persist still in
            # flight must commit (or fail) before the controller kills
            # this worker, or the attempt's last checkpoint is lost.
            try:
                from ray_tpu_torch import checkpoint as _dist_ckpt

                _dist_ckpt.wait_pending(timeout=30.0)
            # tpulint: allow(broad-except reason=persist failures are already logged by the saver thread; the attempt outcome must not change because its LAST checkpoint failed — resume just uses an older one)
            except Exception:
                pass
            # One slice per controller attempt in the timeline: restart
            # churn is visible as gaps between attempt spans.
            tracing.emit_span(
                "train:attempt",
                attempt_start,
                time.time() - attempt_start,
                train_job=self.ctx.experiment_name,
                train_attempt=self.ctx.attempt,
                train_rank=self.ctx.rank,
            )
            # The controller kills this worker right after the attempt
            # resolves — flush now or the attempt's last second of
            # spans/metrics (the goodput boundary) dies with it.
            try:
                import asyncio as _asyncio

                rt = ray_tpu_torch.api._runtime
                if rt.core is not None:
                    rt.run(
                        _asyncio.wait_for(
                            rt.core.flush_observability(), 5.0
                        )
                    )
            except Exception:  # noqa: BLE001 - flush is best-effort
                logger.debug(
                    "attempt-end observability flush failed", exc_info=True
                )
        return {
            "rank": self.rank,
            "reports": self.ctx.reports,
            "latest_metrics": self.ctx.latest_metrics,
        }


class TorchTrainer:
    """Data-parallel / FSDP PyTorch training over a gang-scheduled worker
    group (the JAX package's ``JaxTrainer``). The user's
    ``train_loop_per_worker`` builds its mesh with
    ray_tpu_torch.parallel.make_mesh and shards with the rule table — the
    trainer owns process placement, rendezvous env, checkpoints, and
    retries; torch.distributed owns the collectives."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        scaling_policy: ScalingPolicy | None = None,
        datasets: dict | None = None,
    ):
        self.train_loop = train_loop_per_worker
        self.config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.scaling_policy = scaling_policy or ScalingPolicy()
        # name → ray_tpu_torch.data.Dataset; split per worker at fit() time
        # (reference: DataConfig splits ray.data streams per worker,
        # train/v2/_internal/data_integration/).
        self.datasets = datasets or {}
        # Sweep-engine stop hook: request_stop() kills the current
        # attempt's gang and makes fit() return (latest checkpoint,
        # no error) instead of retrying — an ASHA rung kill must not
        # fight the controller's own failure policy.
        self._stop_requested = False
        self._live_workers: list = []

    def request_stop(self) -> None:
        """Stop this trainer from another thread: the current gang is
        killed and fit() returns its latest checkpoint without
        retrying. Idempotent; safe before fit() starts (the first
        attempt is then skipped)."""
        self._stop_requested = True
        for w in list(self._live_workers):
            try:
                ray_tpu_torch.kill(w)
            except RayTpuError:
                pass

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested

    def _split_datasets(self, n: int) -> list[dict]:
        """Materialize each dataset and deal its block refs round-robin:
        worker i gets shard dicts {name: [refs]} — refs resolve from any
        process (ownership model), so shards ship as plain messages.
        TokenDatasets (native file loaders) ship as descriptors instead:
        each worker re-opens its own mmap and takes a (rank, world)
        stripe of the shuffled permutation."""
        from ray_tpu_torch.train.dataloader import TokenDataset

        shards: list[dict] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if isinstance(ds, TokenDataset):
                desc = ds.descriptor()
                for i in range(n):
                    shards[i][name] = {**desc, "rank": i, "world": n}
                continue
            refs = ds.materialize()._refs
            for i in range(n):
                shards[i][name] = refs[i::n]
        return shards

    # ------------------------------------------------------------ fit
    def fit(self) -> Result:
        failures = 0
        resume = self.run_config.resume_from_checkpoint
        latest_checkpoint: str | None = (
            self._find_latest_checkpoint() if resume == "auto" else resume
        )
        last_err: Exception | None = None
        while not self._stop_requested:
            n = self._policy_workers(failures, last_err)
            try:
                return self._run_attempt(latest_checkpoint, failures, n)
            except Exception as e:  # noqa: BLE001 - controller retry loop
                if self._stop_requested:
                    # The attempt died because request_stop() killed the
                    # gang — that is a clean stop, not a failure.
                    latest_checkpoint = (
                        self._find_latest_checkpoint() or latest_checkpoint
                    )
                    last_err = None
                    break
                logger.warning(
                    "train attempt %d failed (%s: %s); %s",
                    failures,
                    type(e).__name__,
                    e,
                    "retrying"
                    if failures < self.run_config.failure_config.max_failures
                    else "out of retries",
                )
                last_err = e
                failures += 1
                latest_checkpoint = (
                    self._find_latest_checkpoint() or latest_checkpoint
                )
                if failures > self.run_config.failure_config.max_failures:
                    break
                self._settle_cluster_view(e)
        return Result(
            metrics={},
            checkpoint=latest_checkpoint,
            path=self._run_dir(),
            error=last_err,
        )

    def _policy_workers(
        self, attempt: int, last_err: Exception | None
    ) -> int:
        try:
            return self.scaling_policy.workers_for_attempt(
                self.scaling,
                attempt,
                self._cluster_free(),
                last_error=last_err,
            )
        except TypeError:
            # User policy predating the last_error hook.
            return self.scaling_policy.workers_for_attempt(
                self.scaling, attempt, self._cluster_free()
            )

    @staticmethod
    def _is_preemption(err: Exception | None) -> bool:
        """Did the attempt unwind on a drain-notice emergency checkpoint
        (PreemptedError)? Like collective aborts, the failure is
        *detected*, not inferred — the retry can size and start as soon
        as the node table holds still."""
        from ray_tpu_torch.exceptions import PreemptedError

        seen = 0
        while err is not None and seen < 8:
            if isinstance(err, PreemptedError) or "PreemptedError" in str(
                err
            ):
                return True
            err = getattr(err, "cause", None) or err.__cause__
            seen += 1
        return False

    @staticmethod
    def _is_collective_abort(err: Exception | None) -> bool:
        """Did the attempt fail on a typed collective abort? Checks the
        exception and its carried causes — worker errors arrive wrapped
        in RayTaskError with the original in .cause (or stringified when
        unpicklable)."""
        from ray_tpu_torch.collective.types import CollectiveError

        seen = 0
        while err is not None and seen < 8:
            if isinstance(err, CollectiveError):
                return True
            if any(
                name in str(err)
                for name in (
                    "CollectiveTimeoutError",
                    "CollectiveMemberDiedError",
                )
            ):
                return True
            err = getattr(err, "cause", None) or err.__cause__
            seen += 1
        return False

    def _settle_cluster_view(self, err: Exception | None) -> None:
        """Let the cluster view settle before sizing the retry.

        Default failure (a hang inferred from worker death): the dead
        slice must age out of the node table (HEALTH_TIMEOUT_S) and
        survivors' heartbeats must republish bundles freed by the failed
        attempt's PG — wait the full window.

        Collective abort: the failure was *detected*, and the abort path
        already probed the head (collective_probe removes a confirmed-
        dead node immediately), so poll until the node table holds still
        instead of sleeping the worst case."""
        from ray_tpu_torch._private import config as _config

        budget = _config.get("HEALTH_TIMEOUT_S") + 2.0
        if not (self._is_collective_abort(err) or self._is_preemption(err)):
            time.sleep(budget)
            return
        deadline = time.monotonic() + budget
        prev: frozenset | None = None
        stable = 0
        while time.monotonic() < deadline:
            try:
                rt = ray_tpu_torch.api._runtime
                status = rt.run(rt.core.head.call("cluster_status"))
                view = frozenset(status.get("nodes", {}).keys())
            # tpulint: allow(broad-except reason=the head may be mid-restart during settle; an unreadable view just means "not stable yet" and the loop keeps polling inside its deadline)
            except Exception:  # noqa: BLE001 - head busy: keep waiting
                view = None
            stable = stable + 1 if view is not None and view == prev else 0
            prev = view
            if stable >= 3:
                return
            time.sleep(0.5)

    def _cluster_free(self) -> list[dict]:
        """Per-live-node available resources (the scaling policy's view
        of what an attempt can place). Draining nodes are excluded —
        counting a preempting node's capacity would size an attempt the
        placement layer can no longer satisfy. Slice-labeled nodes
        additionally carry ``_slice`` (the fault-domain id) and
        ``_slice_whole`` (False when ANY sibling of the slice is
        draining/dead/unhealthy): a slice dies as a unit, so the
        elastic policy must count whole surviving slices, not the
        stray healthy bundles of a condemned one."""
        try:
            rt = ray_tpu_torch.api._runtime
            status = rt.run(rt.core.head.call("cluster_status"))
            draining = set(status.get("draining") or {})
            node_slice: dict[str, str] = {}
            whole: dict[str, bool] = {}
            for sid, rec in (status.get("slices") or {}).items():
                members = list(rec.get("nodes") or [])
                for nid in members:
                    node_slice[nid] = sid
                whole[sid] = (
                    rec.get("state") == "healthy"
                    and not any(nid in draining for nid in members)
                )
            out = []
            for nid, n in status.get("nodes", {}).items():
                if nid in draining:
                    continue
                avail = dict(n.get("available", {}))
                sid = node_slice.get(nid)
                if sid is not None:
                    avail["_slice"] = sid
                    avail["_slice_whole"] = whole.get(sid, False)
                out.append(avail)
            return out
        except Exception:  # noqa: BLE001 - policy falls back to config
            logger.debug(
                "cluster_status unavailable; scaling policy sees an "
                "empty free list", exc_info=True,
            )
            return []

    def _run_dir(self) -> str:
        import os

        return os.path.join(
            self.run_config.storage_path, self.run_config.name
        )

    def _find_latest_checkpoint(self) -> str | None:
        """Newest VALID checkpoint for the resume path: the newest
        non-empty report()-persisted dir (a dying attempt can leave a
        half-copied or empty newest dir behind — fall back to the
        previous entry, the restore_latest_valid semantics), else the
        newest COMPLETE in-cluster shard-store checkpoint for this run
        as a ``ckpt://`` URI — so a cluster with no shared checkpoint
        directory still resumes from replicas."""
        import os

        from ray_tpu_torch.train.checkpoint import list_checkpoint_dirs

        d = self._run_dir()
        for _idx, name in reversed(list_checkpoint_dirs(d)):
            path = os.path.join(d, name)
            try:
                if os.path.isdir(path) and os.listdir(path):
                    return path
            except OSError:
                continue
        return self._latest_store_checkpoint()

    def _latest_store_checkpoint(self) -> str | None:
        """Newest complete shard-store checkpoint URI for this run (the
        head's manifest table), or None (also on a degraded head — the
        resume path must never fail the controller)."""
        try:
            from ray_tpu_torch import checkpoint as dist_ckpt

            step = dist_ckpt.latest_step(self.run_config.name)
            if step is not None:
                return dist_ckpt.make_uri(self.run_config.name, step)
        # tpulint: allow(broad-except reason=resume discovery must never fail the controller; a degraded/absent head just means no store checkpoint to offer)
        except Exception:
            pass
        return None

    def _backend_env(
        self, rank: int, attempt: int = 0, n_workers: int | None = None
    ) -> dict:
        """Worker env for the torch backend (reference: TorchTrainer's
        _TorchBackend, python/ray/train/torch/config.py)."""
        n = n_workers or self.scaling.num_workers
        env = {
            "RAY_TPU_TRAIN_RANK": str(rank),
            "RAY_TPU_TRAIN_WORLD": str(n),
        }
        # Attempt is always exposed (not only for distributed) so train
        # loops can scope their own collective groups per attempt.
        env["RAY_TPU_TRAIN_ATTEMPT"] = str(attempt)
        if self.run_config.sweep_id:
            env["RAY_TPU_TRAIN_SWEEP_ID"] = self.run_config.sweep_id
        if self.run_config.trial_id:
            env["RAY_TPU_TRAIN_TRIAL_ID"] = self.run_config.trial_id
        if self.scaling.collective_timeout_s is not None:
            env["RAY_TPU_TRAIN_COLLECTIVE_TIMEOUT_S"] = str(
                self.scaling.collective_timeout_s
            )
        if self.scaling.allow_partial_grads:
            env["RAY_TPU_TRAIN_PARTIAL_GRADS"] = "1"
            env["RAY_TPU_TRAIN_PARTIAL_MIN_FRACTION"] = str(
                self.scaling.partial_min_fraction
            )
            if self.scaling.partial_grace_s is not None:
                env["RAY_TPU_TRAIN_PARTIAL_GRACE_S"] = str(
                    self.scaling.partial_grace_s
                )
        if self.scaling.grad_compression:
            env["RAY_TPU_TRAIN_GRAD_COMPRESSION"] = str(
                self.scaling.grad_compression
            )
        if self.scaling.grad_overlap:
            env["RAY_TPU_TRAIN_GRAD_OVERLAP"] = "1"
        if self.scaling.grad_bucket_mb is not None:
            env["RAY_TPU_TRAIN_GRAD_BUCKET_MB"] = str(
                self.scaling.grad_bucket_mb
            )
        if self.scaling.grad_error_feedback:
            env["RAY_TPU_TRAIN_GRAD_ERROR_FEEDBACK"] = "1"
        if self.scaling.zero_sharding:
            env["RAY_TPU_TRAIN_ZERO_SHARDING"] = "1"
        if self.scaling.distributed and n > 1:
            env["RAY_TPU_TRAIN_DISTRIBUTED"] = "1"
            env["RAY_TPU_TRAIN_DIST_BACKEND"] = self.scaling.dist_backend
            if self.scaling.use_gpu:
                env["RAY_TPU_TRAIN_GPUS_PER_WORKER"] = str(
                    self.scaling.gpus_per_worker)
        return env

    def _run_attempt(
        self,
        latest_checkpoint: str | None,
        attempt: int = 0,
        n_workers: int | None = None,
    ) -> Result:
        n = n_workers or self.scaling.num_workers
        pg = placement_group(
            [self.scaling.bundle() for _ in range(n)],
            strategy=self.scaling.placement_strategy,
        )
        workers = []
        try:
            workers = [
                TrainWorker.options(
                    placement_group=pg,
                    placement_group_bundle_index=i,
                    # Request what the bundle reserved: a non-default
                    # resources_per_worker (fractional CPUs, GPUs)
                    # must be leased by the worker actor itself, not
                    # just held by the bundle.
                    resources=self.scaling.bundle(),
                ).remote(i, n)
                for i in range(n)
            ]
            self._live_workers = workers
            shards = self._split_datasets(n)
            ray_tpu_torch.get(
                [
                    w.setup.remote(
                        self.run_config.name,
                        self.run_config.storage_path,
                        self.config,
                        latest_checkpoint,
                        self._backend_env(i, attempt, n),
                        shards[i],
                    )
                    for i, w in enumerate(workers)
                ],
                timeout=60,
            )
            import inspect

            use_arg = len(inspect.signature(self.train_loop).parameters) > 0
            refs = [
                w.run_loop.remote(self.train_loop, use_arg) for w in workers
            ]
            results = ray_tpu_torch.get(refs)
            rank0 = next(r for r in results if r["rank"] == 0)
            return Result(
                metrics=rank0["latest_metrics"],
                checkpoint=self._find_latest_checkpoint(),
                path=self._run_dir(),
            )
        finally:
            self._live_workers = []
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except RayTpuError:
                    pass
            remove_placement_group(pg)
            time.sleep(0.1)  # let worker teardown settle before re-slicing
