"""tokenizer.bin format: max_token_length int32, then per token a
(score fp32, len int32, bytes) record.

Written by the reference's train/tokenizer.py:62-70, parsed by
src/llama.cpp:52-76. The vocab size is NOT in the file; callers pass it.
"""

from __future__ import annotations

import struct


def read_tokenizer_bin(path: str, vocab_size: int) -> tuple[int, list[bytes], list[float]]:
    """Returns (max_token_length, vocab pieces as bytes, scores)."""
    vocab: list[bytes] = []
    scores: list[float] = []
    with open(path, "rb") as f:
        (max_token_length,) = struct.unpack("i", f.read(4))
        for _ in range(vocab_size):
            score, length = struct.unpack("fi", f.read(8))
            vocab.append(f.read(length))
            scores.append(score)
    return max_token_length, vocab, scores


def write_tokenizer_bin(path: str, vocab: list[bytes], scores: list[float]) -> None:
    max_len = max((len(v) for v in vocab), default=0)
    with open(path, "wb") as f:
        f.write(struct.pack("i", max_len))
        for piece, score in zip(vocab, scores):
            f.write(struct.pack("fi", score, len(piece)))
            f.write(piece)
