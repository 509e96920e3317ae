"""Tokenizer selection: 'auto' picks by vocab size -- 50277 -> the
NeoX/20B BPE, 65536 -> the RWKV World trie.

A copy of ``rwkv_tpu.utils.tokenizer``. The 20B tokenizer needs the
``tokenizers`` package, imported only when it is asked for; the World
tokenizer is pure Python.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Tuple

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"

Decode = Callable[[List[int]], str]
Encode = Callable[[str], List[int]]


def get_tokenizer(name: str = "auto", n_vocab: int | None = None) -> Tuple[Decode, Encode]:
    if name == "auto":
        if n_vocab == 50277:
            name = "20B"
        elif n_vocab == 65536:
            name = "world"
        else:
            raise ValueError(f"Cannot guess tokenizer from n_vocab={n_vocab}")

    if name == "world":
        from rwkv_tpu_torch.utils.world_tokenizer import get_world_tokenizer_v20230424

        return get_world_tokenizer_v20230424()
    if name == "20B":
        import tokenizers

        tok = tokenizers.Tokenizer.from_file(str(_DATA_DIR / "20B_tokenizer.json"))
        return tok.decode, lambda s: tok.encode(s).ids
    raise ValueError(f"Unknown tokenizer {name!r}")


def add_tokenizer_argument(parser) -> None:
    parser.add_argument(
        "tokenizer",
        help="Tokenizer: auto (guess from n_vocab), 20B, world",
        nargs="?",
        type=str,
        default="auto",
    )
