"""Models of the port."""

from ray_tpu_torch.models.llama import (
    PRESETS,
    LlamaConfig,
    forward,
    forward_with_aux,
    init_params,
    params_from_jax,
)

__all__ = ["PRESETS", "LlamaConfig", "forward", "forward_with_aux",
           "init_params", "params_from_jax"]
