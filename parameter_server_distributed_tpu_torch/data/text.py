"""Byte-level tokenizer (the port's own copy of ByteTokenizer and
require_vocab from parameter_server_distributed_tpu/data/text.py)."""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0-255 are bytes, 256=BOS, 257=EOS."""

    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in np.asarray(ids).reshape(-1)
                     if int(i) < 256)
        return data.decode("utf-8", errors="replace")


def require_vocab(model_vocab: int, tokenizer: ByteTokenizer) -> None:
    """Raise when a model's vocabulary cannot cover the tokenizer's ids."""
    if model_vocab < tokenizer.vocab_size:
        raise ValueError(
            f"model vocab {model_vocab} < byte tokenizer vocab "
            f"{tokenizer.vocab_size}; use a vocab>={tokenizer.vocab_size} "
            f"LM for text prompts/corpora")
