"""Byte-level tokenizer (own copy of ray_tpu/llm/tokenizer.py): 256 byte
ids plus PAD/BOS/EOS. Any object with encode(str) -> list[int] and
decode(list[int]) -> str can stand in for it."""

from __future__ import annotations


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.BOS] + ids if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")
