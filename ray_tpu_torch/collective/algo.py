"""Topology-aware collective algorithm selection.

The Big Send-off (arXiv:2504.18658) shows algorithm choice by message
size and topology is worth integer factors at scale. Three levers here:

- **Ring vs tree by message size** (:func:`choose_algorithm`): a
  flat ring is bandwidth-optimal (moves ``2(n-1)/n * N`` per rank over
  ``2(n-1)`` latency-bound steps); a binomial tree moves the full
  message each of ``~2*log2(n)`` rounds but pays exponentially fewer
  latency terms — it wins below a per-world-size crossover message
  size. The crossover table is overridable via config
  ``COLLECTIVE_ALGO_CROSSOVER``.
- **Hierarchical two-level allreduce for multi-slice device sets**
  (:func:`hierarchical_allreduce`): reduce-scatter inside the slice
  (on GPUs, a node's NVLink domain), allreduce the scattered shards
  across slices over the slower inter-node link ("DCN" below; 1/m of
  the bytes), all-gather back inside the slice. The slow inter-domain
  link carries ``2(s-1)/s * N/m`` instead of ``2(n-1)/n * N``.
- **Honest accounting** (:func:`wire_bytes_per_rank`): per-algorithm
  bytes-on-the-wire estimates feeding the flight recorder's wire
  counter and busbw gauge for ops whose transfers the host cannot
  measure (NCCL's and the device-local routes').
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np

# Algorithm names accepted by the collective verbs' ``algo=`` kwarg.
HUB = "hub"            # cpu backend's default star reduce (rank 0 hub)
RING = "ring"          # flat ring: bandwidth-optimal, O(n) latency terms
TREE = "tree"          # binomial tree: O(log n) latency terms, full-N rounds
AUTO = "auto"          # pick ring/tree by message size (crossover table)
HIERARCHICAL = "hierarchical"  # two-level ICI/DCN (multi-slice meshes)

ALGOS = (HUB, RING, TREE, AUTO, HIERARCHICAL)

# Default tree→ring crossover (bytes) by world size: the ring's 2(n-1)
# latency terms take longer to amortize as the group grows, so the tree
# keeps winning to larger messages. Largest key <= world applies.
_DEFAULT_CROSSOVER = {
    2: 64 << 10,
    4: 128 << 10,
    8: 256 << 10,
    16: 512 << 10,
    32: 1 << 20,
}


def _crossover_table() -> dict[int, int]:
    """Config-overridable crossover table. ``COLLECTIVE_ALGO_CROSSOVER``
    accepts a single byte count ("65536" — every world size) or
    per-world entries ("2:65536,8:262144")."""
    from ray_tpu_torch._private import config

    spec = str(config.get("COLLECTIVE_ALGO_CROSSOVER") or "").strip()
    if not spec:
        return dict(_DEFAULT_CROSSOVER)
    if ":" not in spec:
        return {2: int(spec)}
    table: dict[int, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        w, _, b = part.partition(":")
        table[int(w)] = int(b)
    return table or dict(_DEFAULT_CROSSOVER)


def crossover_bytes(world: int) -> int:
    """Message size (bytes) at which ring overtakes tree for ``world``."""
    table = _crossover_table()
    eligible = [w for w in table if w <= max(2, int(world))]
    return table[max(eligible)] if eligible else min(table.values())


def choose_algorithm(
    nbytes: int,
    world: int,
    n_slices: int = 1,
    override: str | None = None,
    verb: str = "allreduce",
) -> str:
    """Pick the data-plane algorithm for a payload of ``nbytes``/rank.

    ``override`` short-circuits (any explicit non-AUTO algo wins).
    Multi-slice topologies always take the hierarchical two-level path —
    keeping the DCN hop at 1/m of the bytes beats either flat algorithm
    whenever more than one ICI domain is involved. Otherwise: tree below
    the crossover size, ring above.

    ``verb`` extends the crossover routing to the reduce-scatter /
    all-gather hops of the ZeRO-sharded gradient path: the same
    size-vs-latency tradeoff applies (ring moves (n-1)/n of the bytes
    over n-1 latency-bound hops; the latency-optimal plane — hub star
    on the cpu backend, one-shot lowering on the compiled backends,
    both mapped from TREE — moves more bytes in O(1)/O(log n) rounds),
    minus the hierarchical route, which is an allreduce-only driver
    op."""
    if override is not None and override != AUTO:
        if override not in ALGOS:
            raise ValueError(
                f"unknown collective algo {override!r}; known: {ALGOS}"
            )
        return override
    if n_slices > 1 and verb == "allreduce":
        return HIERARCHICAL
    if world <= 2:
        # Two ranks: ring and tree degenerate to the same exchange; call
        # it tree (one round) so tiny groups never pay ring bookkeeping.
        return TREE
    return TREE if nbytes < crossover_bytes(world) else RING


def wire_bytes_per_rank(
    algo: str,
    nbytes: int,
    world: int,
    n_slices: int = 1,
    compressed_nbytes: int | None = None,
    verb: str = "allreduce",
) -> int:
    """Per-rank bytes ``verb`` moves on the wire under ``algo``.

    ``nbytes`` is the op's LOGICAL per-rank payload by the flight
    recorder's convention: the full flat payload for allreduce and
    reducescatter, this rank's contribution for allgather.
    ``compressed_nbytes`` substitutes the quantized payload size (int8
    data + scales) for the phases that ship compressed data. These are
    the analytic counts the flight recorder's wire counter uses for ops
    whose transfers run inside a compiled program (or through the hub,
    where the payload sizes are measured — this function is the
    estimator for the rest)."""
    n = max(1, int(world))
    payload = int(compressed_nbytes if compressed_nbytes is not None
                  else nbytes)
    if n == 1:
        return 0
    if verb == "reducescatter":
        if algo == RING:
            # n-1 hops, each shipping one 1/n chunk.
            return int((n - 1) / n * payload)
        if algo == HUB:
            # full contribution up, the 1/n chunk back down.
            return payload + payload // n
        if algo == TREE:
            # one-shot / reduce-then-slice: the reduce tree's bytes.
            return int(math.ceil(math.log2(n)) * payload)
        raise ValueError(
            f"unknown reducescatter algo {algo!r}; known: {ALGOS}"
        )
    if verb == "allgather":
        if algo == RING:
            # n-1 hops, each forwarding one rank's contribution.
            return (n - 1) * payload
        if algo == HUB:
            # contribution up, the n gathered chunks back down.
            return (n + 1) * payload
        if algo == TREE:
            # recursive-doubling broadcast of the growing gather.
            return int(math.ceil(math.log2(n)) * n * payload)
        raise ValueError(
            f"unknown allgather algo {algo!r}; known: {ALGOS}"
        )
    if algo == HUB:
        return 2 * payload  # one round trip: contribution up, result down
    if algo == RING:
        # reduce-scatter + all-gather, each (n-1)/n of the payload out.
        return int(2 * (n - 1) / n * payload)
    if algo == TREE:
        # binomial reduce up + broadcast down: log2(n) full-payload sends.
        return int(2 * math.ceil(math.log2(n)) * payload)
    if algo == HIERARCHICAL:
        s = max(1, int(n_slices))
        m = max(1, n // s)
        ici = int(2 * (m - 1) / m * payload) if m > 1 else 0
        dcn = int(2 * (s - 1) / s * (payload / m)) if s > 1 else 0
        return ici + dcn
    raise ValueError(f"unknown collective algo {algo!r}; known: {ALGOS}")


# ----------------------------------------------- hierarchical (torch)
# Per-slice DCN skip bookkeeping for the hierarchical partial op: the
# analogue of the cpu hub's per-rank skip window, at slice granularity.
# A slice chronically skipped on the DCN hop escalates to the head
# (collective_slice_report) which drains the WHOLE slice — feeding the
# same drain-and-replace path the rank-level chronic-skip signal uses.
import threading as _threading

_slice_lock = _threading.Lock()
_slice_skips: dict[str, dict[int, int]] = {}         # group → slice → total
_slice_skip_events: dict[str, list] = {}             # group → [(ts, slice)]
_slice_reported: dict[str, set] = {}                 # group → reported slices


def slice_skip_stats(group: str = "hier") -> dict[int, int]:
    """Per-slice DCN-hop skip counts of the hierarchical partial
    allreduce for ``group`` (merged into
    ``collective.straggler_stats()`` as ``slice_skip_counts``)."""
    with _slice_lock:
        return dict(_slice_skips.get(group, {}))


def _note_slice_skips(group: str, skipped: Sequence[int]) -> None:
    """Count skips, slide the escalation window, and report a slice
    whose skip rate crossed the chronic threshold to the head (which
    drains the whole slice). Fire-and-forget: telemetry and escalation
    must never fail the op."""
    import time as _time

    from ray_tpu_torch._private import config

    window = config.get("COLLECTIVE_SKIP_WINDOW_S")
    threshold = config.get("COLLECTIVE_SKIP_DRAIN_THRESHOLD")
    now = _time.monotonic()
    chronic: list[tuple[int, int]] = []
    with _slice_lock:
        counts = _slice_skips.setdefault(group, {})
        events = _slice_skip_events.setdefault(group, [])
        reported = _slice_reported.setdefault(group, set())
        for si in skipped:
            counts[si] = counts.get(si, 0) + 1
            events.append((now, si))
        cutoff = now - window
        events[:] = [e for e in events if e[0] >= cutoff]
        in_window: dict[int, int] = {}
        for _ts, si in events:
            in_window[si] = in_window.get(si, 0) + 1
        for si, cnt in in_window.items():
            if cnt >= threshold and si not in reported:
                reported.add(si)
                chronic.append((si, cnt))
    if not chronic:
        return
    try:
        import ray_tpu_torch.api as _api

        rt = _api._runtime
        if not rt.ready:
            return
        for si, cnt in chronic:
            rt.run(
                rt.core.head.call(
                    "collective_slice_report",
                    group=group,
                    slice_id=str(si),
                    skips=int(cnt),
                    window_s=float(window),
                )
            )
    # tpulint: allow(broad-except reason=escalation is advisory; without a runtime or a new-enough head the skip metrics still carry the signal)
    except Exception:
        pass


def _slice_count(devices: Sequence) -> int:
    return len({getattr(d, "slice_index", 0) for d in devices})


def hier_dcn_wire_bytes(
    length: int,
    itemsize: int,
    world: int,
    n_slices: int,
    block: int | None = None,
) -> int:
    """Per-rank bytes the hierarchical allreduce's DCN hop moves.

    Uncompressed: the inter-slice allreduce of the 1/m shard,
    ``2(s-1)/s * length/m * itemsize``. With ``block`` (the int8 codec
    on the DCN hop only): int8 data + 1/block fp32 scales through the
    all_to_all + all_gather pair."""
    s = max(1, int(n_slices))
    n = max(1, int(world))
    m = max(1, n // s)
    if s <= 1:
        return 0
    shard_len = max(1, math.ceil(max(1, length) / m))
    if block is None:
        return int(2 * (s - 1) / s * shard_len * itemsize)
    from ray_tpu_torch.collective import codec

    chunk_len = codec.padded_len(-(-shard_len // s), block)
    q_payload = s * (chunk_len + (chunk_len // block) * 4)
    return int(2 * (s - 1) / s * q_payload)


def hierarchical_allreduce(
    tensors: Sequence[Any],
    devices: Sequence | None = None,
    n_slices: int | None = None,
    group: str = "hier",
    min_slices: int | None = None,
    grace_s: float | None = None,
    skip_slices: Sequence[int] | None = None,
    compression: str | None = None,
):
    """Two-level allreduce over a multi-slice device set.

    ``tensors`` is one per-device torch tensor (single-controller
    semantics, like :class:`NcclMeshGroup`); ``devices`` default to every
    visible CUDA device and are split into ``n_slices`` contiguous slices
    (inferred from ``device.slice_index`` when present: on GPUs a slice is
    a set of devices on one fast domain, such as a node's NVLink; the
    :class:`SliceDevice` shim carries a fake one). Eager torch runs

        reduce-scatter inside each slice  →  allreduce across slices  →
        all-gather inside each slice

    so the slow inter-slice hop moves ``1/m`` of the payload per rank.
    Single-slice inputs degenerate to a flat sum (one slice of m). Returns
    the per-device reduced tensors, each on its device, numerically equal
    to a flat allreduce up to fp32 reassociation (summed within each
    slice in rank order, then across slices in slice order).

    **DCN-partial mode** (``min_slices=`` / ``skip_slices=``): the
    slice is the failure unit — the intra-slice reduce-scatter and
    all-gather stay EXACT, and the masked-partial semantics apply only to
    the inter-slice reduce: a dead or slow slice contributes weight 0 and
    the sum is rescaled by ``S/Σw`` so the mean over contributing slices
    is preserved. Returns a typed :class:`PartialResult` whose
    ``contributed``/``skipped`` lists name SLICE indices (``world`` =
    number of slices). ``skip_slices`` is the explicit dead set (drain
    notices, external health signals); the ``RAY_TPU_SLICE_FAIL`` chaos
    knob adds deterministic failures — a "kill"-failed slice is treated
    as dead, a delayed slice is skipped when its delay exceeds
    ``grace_s`` (config COLLECTIVE_PARTIAL_GRACE_S when None). Fewer than
    ``min_slices`` surviving slices raises
    :class:`CollectiveTimeoutError`. Skips feed per-slice DCN metrics,
    ``slice_skip_stats()``, and — past the chronic threshold — a
    ``collective_slice_report`` to the head, which drains the whole
    slice.

    **Compressed DCN hop** (``compression="int8"``): the block-scaled
    int8 codec applies to the inter-slice exchange ONLY (quantize →
    all_to_all → fp32 accumulate → S/Σw rescale → requantize →
    all_gather) while both intra-slice hops stay exact. Composes with
    partial mode."""
    import time

    import torch

    from ray_tpu_torch.collective import codec
    from ray_tpu_torch.collective.flight_recorder import (
        record_dcn_slices,
        record_op,
        record_partial,
    )
    from ray_tpu_torch.collective.types import (
        CollectiveTimeoutError,
        PartialResult,
    )

    if devices is None:
        devices = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
    devices = list(devices)
    n = len(devices)
    if len(tensors) != n:
        raise ValueError(
            f"expected {n} per-device tensors, got {len(tensors)}"
        )
    s = int(n_slices) if n_slices is not None else _slice_count(devices)
    s = max(1, s)
    if n % s:
        raise ValueError(f"{n} devices do not split into {s} slices")
    m = n // s
    compression = codec.check_codec(compression)
    partial = min_slices is not None or skip_slices is not None

    # Dead/slow slice set: explicit skips, then the chaos knob. A
    # "kill"-failed slice is dead (every host of it reaped); a delayed
    # slice is skipped when its delay exceeds the grace window in partial
    # mode — otherwise the op pays the stall, which is exactly what
    # partial mode exists to avoid.
    skipped = sorted({int(si) for si in (skip_slices or ())})
    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch._private.test_utils import slice_fail_action

    if _config.get("SLICE_FAIL"):
        grace = (
            float(grace_s) if grace_s is not None
            else _config.get("COLLECTIVE_PARTIAL_GRACE_S")
        )
        stall = 0.0
        for si in range(s):
            if si in skipped:
                continue
            action = slice_fail_action(si)
            if action is None:
                continue
            kind, val = action
            if kind == "kill" or (partial and val > grace):
                skipped = sorted(set(skipped) | {si})
                partial = True
            elif kind == "delay":
                stall = max(stall, val)
        if stall > 0:
            time.sleep(stall)
    if partial:
        contributed_slices = [si for si in range(s) if si not in skipped]
        if len(contributed_slices) < max(1, int(min_slices or 1)):
            raise CollectiveTimeoutError(
                group,
                "hier_allreduce",
                grace_s,
                missing_ranks=skipped,
                detail=f"only {len(contributed_slices)} of {s} slices "
                       f"contribute, below min_slices {min_slices}",
            )
    runtime = [torch.device(device_of(d)) for d in devices]

    wall_start = time.time()
    t0 = time.perf_counter()
    xs = [torch.as_tensor(t) for t in tensors]
    shape, dtype = xs[0].shape, xs[0].dtype
    length = xs[0].numel()
    pad_to = max(1, math.ceil(length / m)) * m
    if (partial or compression is not None) and not dtype.is_floating_point:
        raise TypeError(
            f"partial/compressed hierarchical allreduce needs a "
            f"floating dtype, got {dtype}"
        )
    block = (
        int(_config.get("COLLECTIVE_COMPRESSION_BLOCK"))
        if compression is not None
        else None
    )
    # Intra-slice reduce-scatter (exact): slice si's sum in rank order,
    # laid out as its m shards [m, pad_to / m], on the slice's first
    # device (row li is the shard of the slice's li-th device).
    shards = []
    for si in range(s):
        lead = runtime[si * m]
        acc = None
        for j in range(si * m, (si + 1) * m):
            flat = torch.nn.functional.pad(
                xs[j].reshape(-1).to(lead), (0, pad_to - length)
            )
            acc = flat.clone() if acc is None else acc.add_(flat)
        shards.append(acc.reshape(m, pad_to // m))
    # Inter-slice allreduce of every shard, on the first device.
    home = runtime[0]
    shards = [sh.to(home) for sh in shards]
    if not partial and compression is None:
        red = shards[0].clone()
        for sh in shards[1:]:
            red.add_(sh)
    else:
        red = _hier_masked(
            shards, [0.0 if si in skipped else 1.0 for si in range(s)], block
        )
    full = red.reshape(-1)[:length].reshape(shape)
    # Intra-slice all-gather: every device gets its own copy.
    result = [full.to(d, copy=True) for d in runtime]
    dur = time.perf_counter() - t0
    itemsize = xs[0].element_size()
    nbytes = itemsize * length
    ici_bytes = (
        int(2 * (m - 1) / m * nbytes) if m > 1 else 0
    )
    dcn_bytes = hier_dcn_wire_bytes(length, itemsize, n, s, block=block)
    record_op(
        group, "hier_allreduce", "nccl_mesh", n, tensors[0],
        wall_start, dur, wire_bytes=ici_bytes + dcn_bytes,
    )
    if s > 1:
        record_dcn_slices(
            group,
            contributed=[si for si in range(s) if si not in skipped],
            skipped=skipped,
            dcn_bytes=dcn_bytes,
            dur=dur,
        )
    if not partial:
        return result
    if skipped:
        record_partial(group, "hier_allreduce", skipped)
        _note_slice_skips(group, skipped)
    return PartialResult(
        value=result,
        contributed=[si for si in range(s) if si not in skipped],
        skipped=skipped,
        world=s,
    )


def _hier_masked(shards, weights, block: int | None):
    """The masked (and optionally compressed) inter-slice reduce of the
    hierarchical allreduce. ``shards[si]`` is slice si's exact
    intra-slice sum ``[m, shard_len]``; ``weights[si]`` its SLICE weight
    (0 = skipped). Each slice's shard is weighted and the sum rescaled by
    ``S/Σw``; with ``block`` the exchange moves int8 + per-block scales:
    each source slice quantizes its weighted shard as S destination
    chunks (the all_to_all), each destination dequantizes and
    accumulates them in fp32 in slice order, rescales and requantizes,
    and the chunks are gathered back (the all_gather) — the codec applied
    to exactly the slow link. Returns the reduced ``[m, shard_len]`` in
    the shards' dtype."""
    import torch

    from ray_tpu_torch.collective import codec

    s = len(shards)
    m, shard_len = shards[0].shape
    dtype, dev = shards[0].dtype, shards[0].device
    w = torch.tensor(weights, dtype=dtype, device=dev)
    scale = s / torch.clamp(w.sum(), min=1.0)
    if block is None:
        red = shards[0] * w[0]
        for si in range(1, s):
            red.add_(shards[si] * w[si])
        return red * scale
    chunk_len = codec.padded_len(-(-shard_len // s), block)
    nblk = chunk_len // block
    xq = torch.stack([(sh * w[si]).float() for si, sh in enumerate(shards)])
    xq = torch.nn.functional.pad(xq, (0, s * chunk_len - shard_len))
    # [S source, m, S dest, nblk, block]
    q, scales = codec.quantize_blocked_torch(xq.reshape(s, m, s, nblk, block))
    deq = q.float() * scales[..., None]
    acc = deq[0].clone()
    for si in range(1, s):
        acc.add_(deq[si])  # fp32 accumulate, source slices in order
    q2, sc2 = codec.quantize_blocked_torch(acc * scale.float())
    full = (q2.float() * sc2[..., None]).reshape(m, -1)[:, :shard_len]
    return full.to(dtype)


class SliceDevice:
    """A device with a ``slice_index``: :func:`hierarchical_allreduce`
    and ``NcclMeshGroup`` group ranks into slices by it (on GPUs a slice
    is a set of devices on one fast domain, such as a node). Lets one
    card, or one node, stand for several slices in tests and dry runs."""

    def __init__(self, device, slice_index: int):
        self._raytpu_device = device
        self.slice_index = int(slice_index)

    def __repr__(self):
        return f"SliceDevice({self._raytpu_device!r}, {self.slice_index})"


def fake_slice_devices(n_slices: int, devices: Sequence) -> list:
    """Partition ``devices`` into ``n_slices`` contiguous fake slices."""
    devices = list(devices)
    if len(devices) % n_slices:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_slices} slices"
        )
    per = len(devices) // n_slices
    return [SliceDevice(d, i // per) for i, d in enumerate(devices)]


def device_of(d):
    """The torch device behind a :class:`SliceDevice` (or ``d`` itself)."""
    return getattr(d, "_raytpu_device", d)
