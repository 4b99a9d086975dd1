"""Models of the port."""

from ray_tpu_torch.models.llama import (
    PRESETS,
    LlamaConfig,
    forward,
    init_params,
    params_from_jax,
)

__all__ = ["PRESETS", "LlamaConfig", "forward", "init_params",
           "params_from_jax"]
