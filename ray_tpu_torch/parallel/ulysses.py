"""Ulysses sequence parallelism: an all-to-all re-shard from sequence to
heads (port of ray_tpu/parallel/ulysses.py).

Where the ring passes K/V blocks around, Ulysses transposes the sharding:
an all-to-all over ``sp`` turns each rank's [B, S / n, H, D] into
[B, S, H / n, D], every rank attends the whole sequence for its group of
heads, and a second all-to-all turns the output back. Both all-to-alls
are differentiable (:func:`~ray_tpu_torch.parallel.collectives.all_to_all`
is its own adjoint).

The attention in the middle is :func:`ray_tpu_torch.ops.flash_attention
.flash_attention`: F1 forward and F2 backward on the card (their plain
versions on the CPU), where the reference calls its plain
``causal_attention``. After the all-to-all it is an ordinary causal
attention over whole sequences, the flash kernels' own job; the
reference's choice was XLA's, whose Pallas kernel it did not wire in
here.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.collectives import all_to_all
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import per_shard


def ulysses_attention_kernel(q, k, v, *, mesh, axis_name: str = "sp",
                             inner: Callable = flash_attention):
    """Per-rank body; q/k/v: [B, S_local, H (or Hkv), D]. all_to_all
    [B, S/n, H, D] -> [B, S, H/n, D]; attention on the local head group
    over the whole sequence; transpose back."""
    n = axis_size(mesh, axis_name)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) and KV heads "
            f"({k.shape[2]}) divisible by sp ({n})")
    qh, kh, vh = (all_to_all(t, mesh, axis_name, split_dim=2, concat_dim=1)
                  for t in (q, k, v))
    oh = inner(qh, kh.contiguous(), vh.contiguous())
    return all_to_all(oh, mesh, axis_name, split_dim=1, concat_dim=2)


def make_ulysses_attention(mesh, batch_axes=("dp", "fsdp"), seq_axis="sp",
                           head_axis="tp"):
    """An attention function (q, k, v -> o) running Ulysses on ``mesh``
    (placements as :func:`~ray_tpu_torch.parallel.ring_attention
    .make_ring_attention`'s)."""

    def kernel(q, k, v):
        return ulysses_attention_kernel(q, k, v, mesh=mesh,
                                        axis_name=seq_axis)

    attn = per_shard(kernel, mesh, batch_axes, seq_axis, head_axis)
    attn.seq_sharded = True  # models/llama.py requires it under sp > 1
    return attn
