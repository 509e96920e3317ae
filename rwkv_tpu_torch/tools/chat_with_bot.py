"""Interactive chat front-end.

    python -m rwkv_tpu_torch.tools.chat_with_bot MODEL [TOKENIZER]
        [--prompt NAME|PATH] [--seed S] [--device cpu]

A port of ``rwkv_tpu.tools.chat_with_bot`` (capability parity with the
reference's python/chat_with_bot.py): persona prompt scripts (JSON), named
saved thread states (snapshot/restore of tokens+logits+state),
`+`-commands, presence/frequency penalties, and the double-newline token
fixup. State snapshots are cheap here: the forward builds new state and
logits tensors and never writes into old ones, so a snapshot just holds
the references. The model runs on the CUDA card unless ``--device`` names
another device.

Commands:
  +reset            — reset to the initial chat prompt
  +gen <text>       — free generation (no chat template)
  +i <instruction>  — instruction template generation
  ++                — retry last generation with a different seed
  +save <name> / +load <name> — named thread states
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.utils.sampling import apply_penalties, sample_logits
from rwkv_tpu_torch.utils.tokenizer import add_tokenizer_argument, get_tokenizer

PROMPTS_DIR = Path(__file__).resolve().parent.parent / "data" / "prompts"

MAX_GENERATION_LENGTH = 250
TEMPERATURE = 0.8
TOP_P = 0.5
PRESENCE_PENALTY = 0.2
FREQUENCY_PENALTY = 0.2


class ChatSession:
    def __init__(self, model: RWKVModel, decode, encode, seed=None):
        self.model = model
        self.decode = decode
        self.encode = encode
        self.rng = np.random.default_rng(seed)
        self.logits = None
        self.state = None
        self.tokens: list[int] = []
        self.saved: dict[str, tuple] = {}

    def process_tokens(self, tokens: list[int]):
        if not tokens:
            return
        self.tokens += tokens
        self.logits, self.state = self.model.eval_sequence_in_chunks(
            tokens, state=self.state
        )

    def snapshot(self):
        return (list(self.tokens), self.logits, self.state)

    def restore(self, snap):
        self.tokens, self.logits, self.state = list(snap[0]), snap[1], snap[2]

    def generate(self, stop_on_double_newline: bool = True, max_len=MAX_GENERATION_LENGTH):
        token_counts: dict[int, int] = {}
        out: list[int] = []
        newlines = 0
        for _ in range(max_len):
            logits = apply_penalties(
                self.logits, token_counts, PRESENCE_PENALTY, FREQUENCY_PENALTY
            )
            token = sample_logits(logits, TEMPERATURE, TOP_P, rng=self.rng)
            token_counts[token] = token_counts.get(token, 0) + 1
            piece = self.decode([token])
            newlines = newlines + 1 if piece.endswith("\n") else 0
            out.append(token)
            print(piece, end="", flush=True)
            self.logits, self.state = self.model.eval(token, self.state)
            self.tokens.append(token)
            if stop_on_double_newline and newlines >= 2:
                break
        return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Chat with an RWKV bot")
    p.add_argument("model_path")
    add_tokenizer_argument(p)
    p.add_argument("--prompt", default="English-Chat", help="Prompt script name or path")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    prompt_path = Path(args.prompt)
    if not prompt_path.exists():
        prompt_path = PROMPTS_DIR / f"{args.prompt}.json"
    script = json.loads(prompt_path.read_text())
    user, bot, separator, init_prompt = (
        script["user"], script["bot"], script["separator"], script["prompt"],
    )

    model = RWKVModel(args.model_path, device=args.device)
    decode, encode = get_tokenizer(args.tokenizer, model.n_vocab)
    chat = ChatSession(model, decode, encode, seed=args.seed)

    print("Processing initial prompt...")
    chat.process_tokens(encode(init_prompt))
    init_snapshot = chat.snapshot()
    print("Chat initialized! Commands: +reset, +gen, +i, ++, +save <n>, +load <n>\n")

    last_input_snapshot = None
    while True:
        try:
            msg = input(f"{user}{separator} ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not msg.strip():
            continue
        if msg == "+reset":
            chat.restore(init_snapshot)
            print("Chat reset.")
            continue
        if msg.startswith("+save "):
            chat.saved[msg[6:].strip()] = chat.snapshot()
            print("Saved.")
            continue
        if msg.startswith("+load "):
            name = msg[6:].strip()
            if name in chat.saved:
                chat.restore(chat.saved[name])
                print("Loaded.")
            else:
                print(f"No saved state {name!r}")
            continue
        if msg == "++":
            if last_input_snapshot is None:
                print("Nothing to retry.")
                continue
            chat.restore(last_input_snapshot)
            print(f"{bot}{separator}", end="")
            chat.generate()
            continue
        if msg.startswith("+gen ") or msg.startswith("+i "):
            text = msg[5:] if msg.startswith("+gen ") else (
                f"\nBelow is an instruction that describes a task."
                f"\n\n# Instruction:\n{msg[3:]}\n\n# Response:\n"
            )
            last_input_snapshot = None
            chat.process_tokens(encode(text))
            chat.generate(stop_on_double_newline=False)
            print()
            continue

        chat.process_tokens(encode(f"{user}{separator} {msg}\n\n{bot}{separator}"))
        last_input_snapshot = chat.snapshot()
        chat.generate()


if __name__ == "__main__":
    main()
