"""LLM serving engine of the port: dense and paged KV caches, continuous
batching, speculative decoding, chunked prefill.

- :class:`LLMEngine` — prefill + decode with continuous batching.
- :func:`build_llm_deployment` — serve integration.
- :func:`build_batch_inferencer` — a callable class holding an engine,
  for batch inference over a dict of prompts.
"""

from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.serve_integration import build_llm_deployment
from ray_tpu_torch.llm.batch import build_batch_inferencer
from ray_tpu_torch.llm.tokenizer import ByteTokenizer

__all__ = [
    "ByteTokenizer",
    "LLMEngine",
    "SamplingParams",
    "build_batch_inferencer",
    "build_llm_deployment",
]
