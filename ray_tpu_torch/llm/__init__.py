"""LLM serving engine of the port: dense and paged KV caches, continuous
batching, speculative decoding, chunked prefill."""

from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "LLMEngine", "SamplingParams"]
