"""Models of the port."""

from ray_tpu_torch.models.llama import (
    PRESETS,
    LlamaConfig,
    forward,
    forward_with_aux,
    init_params,
    params_from_jax,
)
from ray_tpu_torch.models.moe import (
    MOE_PRESETS,
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_forward,
)

__all__ = ["MOE_PRESETS", "PRESETS", "LlamaConfig", "MoEConfig", "forward",
           "forward_with_aux", "init_moe_params", "init_params", "moe_ffn",
           "moe_forward", "params_from_jax"]
