"""Raw text -> token shard (the port's copy of
parameter_server_distributed_tpu/data/text.py).

A plain text corpus becomes the flat binary token shard that
:func:`files.token_stream` memmaps, with no downloaded tokenizer:
:class:`ByteTokenizer` takes UTF-8 bytes as ids (256 bytes + BOS/EOS =
258), and any object with ``encode(text) -> list[int]`` and
``vocab_size`` (a Hugging Face tokenizer, say) may stand in for it.  The
shard writer streams the corpus in chunks cut at whitespace (constant
memory) and picks uint16 or uint32 by vocabulary size, as
:func:`files.load_tokens` reads them back.  Shards are byte-identical to
the JAX package's.
"""

from __future__ import annotations

import os
from typing import Iterator, Protocol

import numpy as np


class Tokenizer(Protocol):
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids) -> str: ...


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


def require_vocab(model_vocab: int, tokenizer: Tokenizer) -> None:
    """Raise when a model's vocabulary cannot cover the tokenizer's ids."""
    if model_vocab < tokenizer.vocab_size:
        raise ValueError(
            f"model vocab {model_vocab} < byte tokenizer vocab "
            f"{tokenizer.vocab_size}; use a vocab>={tokenizer.vocab_size} "
            f"LM for text prompts/corpora")


def _shard_dtype(vocab_size: int) -> np.dtype:
    return np.dtype("<u2") if vocab_size <= 1 << 16 else np.dtype("<u4")


def _whitespace_chunks(src, chunk_bytes: int):
    """The corpus in pieces cut only at whitespace: a word never spans
    two pieces, so a subword tokenizer gives the ids of the whole text
    (one that adds special tokens a call must be told not to)."""
    tail = ""
    while True:
        chunk = src.read(chunk_bytes)
        if not chunk:
            if tail:
                yield tail
            return
        text = tail + chunk
        cut = max(text.rfind(" "), text.rfind("\n"))
        if 0 <= cut < len(text) - 1:
            tail = text[cut + 1:]
            text = text[:cut + 1]
        else:
            tail = ""
        if text:
            yield text


def encode_file(text_path: str, shard_path: str,
                tokenizer: Tokenizer | None = None,
                chunk_bytes: int = 1 << 20,
                add_document_tokens: bool = True) -> int:
    """Tokenize ``text_path`` into the flat binary shard ``shard_path``;
    returns the token count.  The shard is written to a temporary path
    and ``os.replace``d into place, so a crash never leaves a partial
    file that reads as a valid cache.  With ``add_document_tokens`` a BOS
    comes first and an EOS last, where the tokenizer defines them."""
    tokenizer = tokenizer or ByteTokenizer()
    dtype = _shard_dtype(tokenizer.vocab_size)
    bos = getattr(tokenizer, "BOS", None)
    eos = getattr(tokenizer, "EOS", None)
    total = 0
    os.makedirs(os.path.dirname(os.path.abspath(shard_path)), exist_ok=True)
    tmp = f"{shard_path}.tmp.{os.getpid()}"
    try:
        with open(text_path, "r", encoding="utf-8") as src, \
                open(tmp, "wb") as out:
            if add_document_tokens and bos is not None:
                out.write(np.asarray([bos], dtype).tobytes())
                total += 1
            for text in _whitespace_chunks(src, chunk_bytes):
                # checked before the narrowing to the shard dtype, which
                # would wrap an id out of range
                ids = np.asarray(tokenizer.encode(text), np.int64)
                if ids.size and (int(ids.max()) >= tokenizer.vocab_size
                                 or int(ids.min()) < 0):
                    raise ValueError(
                        f"tokenizer produced id outside [0, "
                        f"{tokenizer.vocab_size}) = vocab_size range")
                out.write(ids.astype(dtype).tobytes())
                total += ids.size
            if add_document_tokens and eos is not None:
                out.write(np.asarray([eos], dtype).tobytes())
                total += 1
        os.replace(tmp, shard_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return total


def text_stream(text_path: str, batch_size: int, seq_len: int,
                seed: int = 0, tokenizer: Tokenizer | None = None,
                cache_dir: str | None = None) -> Iterator[np.ndarray]:
    """Endless ``[batch, seq_len]`` int32 numpy batches from a text file:
    encoded on first use into a shard beside it (or in ``cache_dir``),
    again whenever the text is newer than the shard, then random crops
    through :func:`files.token_stream`.  The shard's name carries the
    tokenizer's fingerprint, so another tokenizer encodes anew."""
    from .files import token_stream

    tokenizer = tokenizer or ByteTokenizer()
    fingerprint = f"{type(tokenizer).__name__}{tokenizer.vocab_size}"
    suffix = ".bin" if _shard_dtype(tokenizer.vocab_size).itemsize == 2 \
        else ".u32"
    base = f"{os.path.basename(text_path)}.{fingerprint}{suffix}"
    shard = os.path.join(cache_dir or os.path.dirname(
        os.path.abspath(text_path)), base)
    if (not os.path.exists(shard)
            or os.path.getmtime(shard) < os.path.getmtime(text_path)):
        encode_file(text_path, shard, tokenizer)
    return token_stream(shard, batch_size, seq_len, seed=seed,
                        vocab=tokenizer.vocab_size)
