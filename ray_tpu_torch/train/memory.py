"""Analytic train-step memory planner: predict a configuration's peak
device memory and whether it fits on the card, before spending the card
on it (port of ray_tpu/train/memory.py).

The byte model is the reference's, category by category (per device;
``fsdp`` divides parameters, optimizer state and gradients, ``zero``
the optimizer state only):

- params: fp32 master weights, 4 bytes each;
- optimizer: AdamW's mu (``mu_dtype``; bf16 halves it) and fp32 nu;
- grads: fp32, every leaf at once (the global-norm clip reads them all);
- activations: the [B, S, d] residual stream of every layer in
  ``cfg.dtype``, plus a working set in units of one layer's widest tensor
  [B, S, d_ff]: ``ACT_WORKING_FACTOR`` units once under remat "full",
  ``ACT_DOTS_PER_LAYER_FACTOR`` per layer under "dots" and
  ``ACT_NONE_PER_LAYER_FACTOR`` per layer otherwise. As in the reference,
  every mode other than "full" and "dots" is priced as "none" (ROADMAP.md
  Queue 3 records the quirk; the port keeps it so the two agree);
- cross-entropy: one [B, chunk, V] fp32 logits block and its gradient;
- collective scratch: two gradient buckets in flight, plus the int8
  codec's ~0.26 of a bucket when compression is on.

The factors and ``ALLOCATOR_RESERVE_BYTES`` are fitted to the PyTorch
caching allocator on an H100 (the reference's were fitted to XLA on a
TPU): ``chip_smoke.py`` phase 7 prints each priced peak beside
``torch.cuda.max_memory_allocated`` and the factor the run implies, and
PERF.md keeps the fit and its residuals. The capacity is the card's, from
``torch.cuda.mem_get_info``.
"""

from __future__ import annotations

import dataclasses

import torch

# Resident-state byte widths (train/step.py make_optimizer and
# models/llama.py init_params).
PARAM_BYTES = 4  # fp32 master weights
NU_BYTES = 4     # AdamW's second moment stays fp32
GRAD_BYTES = 4   # fp32 grads (the global-norm clip materialises the tree)

# Working set beyond the residual stream, in units of [B, S, d_ff] in
# cfg.dtype, fitted to torch.cuda.max_memory_allocated on an H100 80GB
# HBM3 (chip_smoke.py planner_checks; the fit and its residuals are in
# PERF.md section 6): remat "full" once (the replayed layer, its
# gradients, the chunked cross-entropy beyond the priced logits block;
# the value that evens the errors on the bench preset, 20.3 implied, and
# the bench_8b recipe, 22.9), "dots" and "none" per layer.
ACT_WORKING_FACTOR = 21.5
ACT_DOTS_PER_LAYER_FACTOR = 3.85
ACT_NONE_PER_LAYER_FACTOR = 7.97

# Device memory the caching allocator cannot hand out, held back from the
# card's capacity: the CUDA context and the libraries' workspaces (0.77
# GiB measured) and the allocator's own slack at a peak (reserved minus
# allocated: 1.18-5.34 GiB at the four priced peaks, the most at the
# bench_8b recipe's), 6.11 GiB together, rounded up.
ALLOCATOR_RESERVE_BYTES = int(6.25 * (1 << 30))

CE_CHUNK = 1024  # train/step.py chunked_cross_entropy default


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """One configuration's predicted peak bytes per device and verdict."""

    n_layers: int
    batch: int
    seq: int
    n_params: int
    params_bytes: int
    optimizer_bytes: int
    grads_bytes: int
    activation_bytes: int
    ce_bytes: int
    scratch_bytes: int
    total_bytes: int
    capacity_bytes: int
    reserve_bytes: int
    usable_bytes: int
    headroom_bytes: int
    fits: bool

    @property
    def total_gb(self) -> float:
        return self.total_bytes / (1 << 30)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["total_gb"] = round(self.total_gb, 2)
        out["headroom_gb"] = round(self.headroom_bytes / (1 << 30), 2)
        return out

    def breakdown(self) -> dict[str, int]:
        return {
            "params": self.params_bytes,
            "optimizer": self.optimizer_bytes,
            "grads": self.grads_bytes,
            "activations": self.activation_bytes,
            "cross_entropy": self.ce_bytes,
            "collective_scratch": self.scratch_bytes,
        }


def _dtype_bytes(dtype) -> int:
    """Width of a dtype given as a torch or numpy dtype, or by name."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    name = getattr(dtype, "__name__", None) or str(dtype)
    name = name.rsplit(".", 1)[-1]
    return {
        "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
        "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    }.get(name, 4)


def default_capacity_bytes() -> int:
    """The current card's total memory (``torch.cuda.mem_get_info``);
    raises without a GPU (pass ``hbm_gb`` to :func:`plan` instead)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "default_capacity_bytes: no CUDA GPU; pass hbm_gb to plan()"
        )
    return int(torch.cuda.mem_get_info()[1])


def plan(
    cfg,
    batch: int,
    seq: int,
    *,
    mu_dtype="bfloat16",
    hbm_gb: float | None = None,
    fsdp: int = 1,
    zero: int = 1,
    grad_bucket_mb: float | None = None,
    compression: str | None = None,
    reserve_bytes: int | None = None,
) -> MemoryPlan:
    """Price one train-step configuration (a LlamaConfig or MoEConfig, a
    batch and a sequence length) against the card's memory. ``fsdp``
    divides the resident state ZeRO-3 style; ``zero`` the optimizer state
    only; ``grad_bucket_mb`` / ``compression`` price the bucketed
    gradient sync's scratch. ``hbm_gb`` sets the capacity (default: the
    card's); ``reserve_bytes`` defaults to ``ALLOCATOR_RESERVE_BYTES``."""
    n_params = int(cfg.num_params())
    shard = max(1, int(fsdp))
    opt_shard = shard * max(1, int(zero))
    params_bytes = n_params * PARAM_BYTES // shard
    mu_bytes = n_params * _dtype_bytes(mu_dtype) // opt_shard
    optimizer_bytes = mu_bytes + n_params * NU_BYTES // opt_shard
    grads_bytes = n_params * GRAD_BYTES // shard
    act_dtype = _dtype_bytes(cfg.dtype)
    boundary = cfg.n_layers * batch * seq * cfg.d_model * act_dtype
    working_unit = batch * seq * cfg.d_ff * act_dtype
    remat = getattr(cfg, "remat", "full")
    if remat == "full":
        activation_bytes = boundary + int(
            ACT_WORKING_FACTOR * working_unit
        )
    elif remat == "dots":
        activation_bytes = boundary + int(
            ACT_DOTS_PER_LAYER_FACTOR * cfg.n_layers * working_unit
        )
    else:  # every other mode is priced as "none" (the reference's rule)
        activation_bytes = boundary + int(
            ACT_NONE_PER_LAYER_FACTOR * cfg.n_layers * working_unit
        )
    chunk = min(CE_CHUNK, seq)
    # logits and their gradient, fp32 (train/step.py chunked_cross_entropy)
    ce_bytes = 2 * batch * chunk * cfg.vocab_size * 4
    scratch_bytes = 0
    if grad_bucket_mb:
        bucket = int(grad_bucket_mb * (1 << 20))
        scratch_bytes = 2 * bucket  # ~2 buckets in flight
        if compression:
            scratch_bytes += int(0.26 * bucket)  # int8 wire + scales
    capacity_bytes = int(
        hbm_gb * (1 << 30) if hbm_gb else default_capacity_bytes()
    )
    if reserve_bytes is None:
        reserve_bytes = ALLOCATOR_RESERVE_BYTES
    usable = capacity_bytes - reserve_bytes
    total = (
        params_bytes + optimizer_bytes + grads_bytes
        + activation_bytes + ce_bytes + scratch_bytes
    )
    return MemoryPlan(
        n_layers=cfg.n_layers,
        batch=batch,
        seq=seq,
        n_params=n_params,
        params_bytes=params_bytes,
        optimizer_bytes=optimizer_bytes,
        grads_bytes=grads_bytes,
        activation_bytes=activation_bytes,
        ce_bytes=ce_bytes,
        scratch_bytes=scratch_bytes,
        total_bytes=total,
        capacity_bytes=capacity_bytes,
        reserve_bytes=reserve_bytes,
        usable_bytes=usable,
        headroom_bytes=usable - total,
        fits=total <= usable,
    )


def bench8b_config(n_layers: int):
    """The bench_8b.py recipe's model: full-size llama3_8b layers, an
    8192-row vocabulary, flash attention, remat "full"."""
    from ray_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(
        PRESETS["llama3_8b"],
        n_layers=n_layers,
        vocab_size=8192,
        attn_impl="flash",
        remat="full",
    )


def plan_bench8b(
    n_layers: int, batch: int, seq: int = 4096, hbm_gb: float | None = None
) -> MemoryPlan:
    """The bench_8b.py recipe (``chip_smoke.py`` phase 6), priced with a
    bf16 mu; ``hbm_gb`` defaults to the card's capacity."""
    return plan(bench8b_config(n_layers), batch, seq, mu_dtype="bfloat16",
                hbm_gb=hbm_gb)
