"""Models of the port: the Llama-style decoder, MoE, and ResNet."""

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
from ray_tpu_torch.models.resnet import PRESETS as RESNET_PRESETS
from ray_tpu_torch.models.resnet import ResNetConfig

__all__ = ["MOE_PRESETS", "PRESETS", "RESNET_PRESETS", "LlamaConfig",
           "MoEConfig", "ResNetConfig", "forward", "forward_with_aux",
           "init_moe_params", "init_params", "moe_ffn", "moe_forward",
           "params_from_jax"]
