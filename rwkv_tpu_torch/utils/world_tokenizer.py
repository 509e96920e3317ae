"""RWKV World tokenizer: byte-level greedy longest-prefix-match.

Functional equivalent of the reference's trie tokenizer
(rwkv.cpp's python/rwkv_cpp/rwkv_world_tokenizer.py), implemented with
a flat dict-of-bytes prefix index instead of a 256-way pointer trie: for each
first byte we keep the candidate tokens sorted by descending length, and
match by slicing — simpler, allocation-light, and fast in CPython for the
65529-entry v20230424 vocabulary.

A copy of ``rwkv_tpu.utils.world_tokenizer``: the default tokenizer is
the native trie (``native.NativeWorldTokenizer``) when the port's native
library is built, which gives the same tokens.

Vocabulary file format: `<idx> <python-literal token> <byte-length>` per
line, where the literal is either a str (utf-8 encoded) or a bytes literal.
"""

from __future__ import annotations

import ast
import functools
import os
from pathlib import Path

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"
DEFAULT_VOCAB = _DATA_DIR / "rwkv_vocab_v20230424.txt"


class WorldTokenizer:
    def __init__(self, vocab_path: str | os.PathLike = DEFAULT_VOCAB):
        self.index_to_token: dict[int, bytes] = {}
        with open(vocab_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                sp1 = line.index(" ")
                sp2 = line.rindex(" ")
                idx = int(line[:sp1])
                tok = ast.literal_eval(line[sp1 + 1 : sp2])
                if isinstance(tok, str):
                    tok = tok.encode("utf-8")
                assert isinstance(tok, bytes) and len(tok) == int(line[sp2 + 1 :])
                self.index_to_token[idx] = tok

        self.token_to_index: dict[bytes, int] = {
            tok: idx for idx, tok in self.index_to_token.items()
        }
        # Per-first-byte candidate lists, longest first (greedy match).
        by_first: dict[int, list[bytes]] = {}
        for tok in self.token_to_index:
            by_first.setdefault(tok[0], []).append(tok)
        self._by_first: dict[int, list[bytes]] = {
            b: sorted(toks, key=len, reverse=True) for b, toks in by_first.items()
        }
        self._max_len = max(len(t) for t in self.token_to_index)

    def encode_bytes(self, src: bytes) -> list[int]:
        tokens: list[int] = []
        pos = 0
        n = len(src)
        while pos < n:
            cands = self._by_first.get(src[pos])
            if not cands:
                raise ValueError(f"byte 0x{src[pos]:02x} not tokenizable at {pos}")
            window = src[pos : pos + self._max_len]
            for tok in cands:
                if window.startswith(tok):
                    tokens.append(self.token_to_index[tok])
                    pos += len(tok)
                    break
            else:
                raise ValueError(f"no token matches input at position {pos}")
        return tokens

    def decode_bytes(self, tokens) -> bytes:
        return b"".join(self.index_to_token[int(t)] for t in tokens)

    def encode(self, src: str) -> list[int]:
        return self.encode_bytes(src.encode("utf-8"))

    def decode(self, tokens) -> str:
        # U+FFFD replacement for partial UTF-8; callers doing incremental
        # decode should buffer tokens until sequences complete.
        return self.decode_bytes(tokens).decode("utf-8", errors="replace")


@functools.lru_cache(maxsize=1)
def _default():
    # Prefer the native trie (bit-exact with this implementation,
    # tests/test_torch_native.py) when the shared library is built.
    from rwkv_tpu_torch import native

    if native.is_available():
        return native.NativeWorldTokenizer()
    return WorldTokenizer()


def get_world_tokenizer_v20230424():
    """Returns (decode, encode) for the default World vocabulary, matching
    the reference's accessor shape (rwkv_world_tokenizer.py:116-126)."""
    tok = _default()
    return tok.decode, tok.encode
