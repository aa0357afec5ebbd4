"""Byte-fallback BPE tokenizer, behaviorally matching the reference.

Reference: src/llama.cpp:34-256 — SentencePiece-compatible vocab loaded from
`tokenizer.bin`, greedy highest-score pair merging, UTF-8 codepoint splitting
with byte fallback (+3 offset past <unk>/<s>/</s>), BOS=1 / EOS=2, dummy " "
prefix for non-empty text, post-BOS leading-space strip on decode.

Pure Python: the JAX package's native C++ encoder is not ported yet, so this
is the merge loop that encoder is held against.
"""

from __future__ import annotations

import re

from hip_llama_tpu_torch.io.tokenizer_io import read_tokenizer_bin

BOS_ID = 1
EOS_ID = 2

_BYTE_RE = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")


class Tokenizer:
    def __init__(self, vocab: list[bytes], scores: list[float], max_token_length: int | None = None):
        self.vocab = vocab
        self.scores = scores
        self.vocab_size = len(vocab)
        self.max_token_length = (
            max_token_length
            if max_token_length is not None
            else max((len(v) for v in vocab), default=0)
        )
        # For duplicate pieces keep the highest-scoring id, mirroring what the
        # merge loop needs (the C bsearch over a strcmp-sorted array returns an
        # arbitrary duplicate; scores are what drive merges).
        self._lookup: dict[bytes, int] = {}
        for i, piece in enumerate(vocab):
            j = self._lookup.get(piece)
            if j is None or scores[i] > scores[j]:
                self._lookup[piece] = i
        # byte-value decode table for <0xXX> tokens (llama.cpp:58-65)
        self._byte_pieces = [bytes([i]) for i in range(256)]

    @classmethod
    def from_file(cls, path: str, vocab_size: int) -> "Tokenizer":
        max_len, vocab, scores = read_tokenizer_bin(path, vocab_size)
        return cls(vocab, scores, max_len)

    # -- encode ------------------------------------------------------------

    def encode(self, text: str | bytes, bos: bool = True, eos: bool = False) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else text
        tokens: list[int] = []
        if bos:
            tokens.append(BOS_ID)
        if data:
            # add_dummy_prefix (llama.cpp:170-173)
            dummy = self._lookup.get(b" ")
            if dummy is not None:
                tokens.append(dummy)

        # UTF-8 codepoint split with byte fallback (llama.cpp:185-227)
        i = 0
        n = len(data)
        while i < n:
            j = i + 1
            # absorb up to 3 continuation bytes (buffer cap str_len < 4)
            while j < n and (data[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            chunk = data[i:j]
            tid = self._lookup.get(chunk)
            if tid is not None:
                tokens.append(tid)
            else:
                tokens.extend(b + 3 for b in chunk)
            i = j

        # greedy highest-score merges (llama.cpp:230-256)
        vocab, scores, lookup = self.vocab, self.scores, self._lookup
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for k in range(len(tokens) - 1):
                mid = lookup.get(vocab[tokens[k]] + vocab[tokens[k + 1]])
                if mid is not None and scores[mid] > best_score:
                    best_score = scores[mid]
                    best_id = mid
                    best_idx = k
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [best_id]

        if eos:
            tokens.append(EOS_ID)
        return tokens

    # -- decode ------------------------------------------------------------

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        """One token's surface bytes (llama.cpp:85-96)."""
        piece = self.vocab[token]
        if prev_token == BOS_ID and piece.startswith(b" "):
            piece = piece[1:]
        m = _BYTE_RE.match(piece)
        if m:
            piece = self._byte_pieces[int(m.group(1), 16)]
        return piece

    def decode(self, tokens: list[int], prev_token: int = BOS_ID) -> str:
        out = bytearray()
        prev = prev_token
        for t in tokens:
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")


def printable_piece(piece: bytes) -> bytes:
    """Filter matching the reference's append_str/safe_printf
    (llama.cpp:99-125): single non-printable, non-whitespace bytes are dropped.
    """
    if not piece:
        return b""
    if len(piece) == 1:
        b = piece[0]
        if not (0x20 <= b <= 0x7E or b in (9, 10, 11, 12, 13)):
            return b""
    return piece
