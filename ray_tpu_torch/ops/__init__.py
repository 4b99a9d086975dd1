"""Tensor ops of the port: plain PyTorch where the reference left the work
to XLA, hand-written CUDA kernels where it had a Pallas kernel."""

from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.flash_attention import (
    flash_attention,
    make_flash_attention,
)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "apply_rope",
    "causal_attention",
    "flash_attention",
    "make_flash_attention",
    "paged_attention",
    "rms_norm",
    "rope_frequencies",
]
