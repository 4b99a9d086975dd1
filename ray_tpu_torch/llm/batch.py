"""Batch inference over ray_tpu_torch.data (ray.llm batch equivalent).

Reference: python/ray/llm/_internal/batch/ runs a vLLM processor inside
Data's actor-pool map; here the processor is a callable class holding an
LLMEngine, handed to Dataset.map_batches(compute="actors") so the
streaming executor scales engine actors and keeps blocks flowing.
"""

from __future__ import annotations

from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.tokenizer import ByteTokenizer


def build_batch_inferencer(
    model="tiny",
    *,
    engine_kwargs: dict | None = None,
    tokenizer=None,
    prompt_column: str = "prompt",
    output_column: str = "generated",
    max_tokens: int = 32,
    temperature: float = 0.0,
):
    """Returns a class for ds.map_batches(..., compute="actors").

    Each data actor owns one engine; a batch's prompts run through the
    engine's continuous batcher together.
    """
    ek = engine_kwargs or {}
    tok = tokenizer

    class LLMInferencer:
        def __init__(self):
            self.engine = LLMEngine(model, **ek)
            self.tokenizer = tok or ByteTokenizer()
            self.sampling = SamplingParams(
                max_tokens=max_tokens, temperature=temperature
            )

        def __call__(self, batch: dict) -> dict:
            prompts = [
                self.tokenizer.encode(p) if isinstance(p, str) else list(p)
                for p in batch[prompt_column]
            ]
            outs = self.engine.generate(prompts, self.sampling)
            batch[output_column] = [self.tokenizer.decode(o) for o in outs]
            return batch

    LLMInferencer.__name__ = f"LLMInferencer_{model}"
    return LLMInferencer

