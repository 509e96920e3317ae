"""Generate text completions from a prompt.

    python -m rwkv_tpu_torch.tools.generate_completions MODEL [TOKENIZER]
        [--prompt TEXT] [--generations N] [--tokens-per-generation N]
        [--temperature T] [--top-p P] [--seed S]
        [--serve PRECISION [--megakernel]] [--device cpu]

A port of ``rwkv_tpu.tools.generate_completions`` (parity with the
reference's python/generate_completions.py): prefill via chunked sequence
eval, then sample N continuations with temperature/top-p; reports
ms/token. The parity engine (``models.model.RWKVModel``) by default, or
with ``--serve`` the port's ``ServingModel`` at that precision (its
kernels on the card). The model runs on the CUDA card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.utils.sampling import host_logits, sample_logits
from rwkv_tpu_torch.utils.tokenizer import add_tokenizer_argument, get_tokenizer


def generate(model, prompt: str, prompt_tokens, decode, generations: int,
             tokens_per_generation: int, temperature: float, top_p: float,
             rng: np.random.Generator) -> list[list[int]]:
    """The tool's loop: prefill `prompt_tokens` once, then `generations`
    sampled continuations of `tokens_per_generation` tokens from that
    state, printed as they come with their ms a token. Returns each
    generation's tokens."""
    init_logits, init_state = model.eval_sequence_in_chunks(prompt_tokens)
    streams = []
    for gen in range(generations):
        print(f"\n--- Generation {gen} ---\n")
        print(prompt, end="")
        logits, state = init_logits, init_state
        tokens = []
        t0 = time.perf_counter()
        for _ in range(tokens_per_generation):
            token = sample_logits(logits, temperature=temperature, top_p=top_p, rng=rng)
            tokens.append(token)
            print(decode([token]), end="", flush=True)
            logits, state = model.eval(token, state)
        dt = time.perf_counter() - t0
        print(f"\nTook {dt:.3f} sec, {dt * 1000 / tokens_per_generation:.2f} ms per token")
        streams.append(tokens)
    return streams


def load_model(model_path: str, serve=None, megakernel: bool = False, device=None):
    """The parity engine, or with `serve` a ServingModel at that precision
    behind ``_ServeAdapter``."""
    if serve:
        from rwkv_tpu_torch.models.serve import ServingModel

        return _ServeAdapter(ServingModel(model_path, precision=serve, megakernel=megakernel,
                                          device=device))
    return RWKVModel(model_path, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate completions from a prompt")
    p.add_argument("model_path")
    add_tokenizer_argument(p)
    p.add_argument("--prompt", default="One upon a time,")
    p.add_argument("--generations", type=int, default=3)
    p.add_argument("--tokens-per-generation", type=int, default=100)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-p", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--serve", default=None, metavar="PRECISION",
        help="use the throughput engine (ServingModel) at this precision "
             "(bf16/q8/q8r/w8a8/w4a8/quant) instead of the parity engine",
    )
    p.add_argument(
        "--megakernel", action="store_true",
        help="with --serve: route decode through the whole-model decode kernel",
    )
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    model = load_model(args.model_path, args.serve, args.megakernel, args.device)
    decode, encode = get_tokenizer(args.tokenizer, model.n_vocab)
    prompt_tokens = encode(args.prompt)
    print(f"{len(prompt_tokens)} tokens in prompt")
    generate(model, args.prompt, prompt_tokens, decode, args.generations,
             args.tokens_per_generation, args.temperature, args.top_p,
             np.random.default_rng(args.seed))


class _ServeAdapter:
    """RWKVModel-shaped eval surface over ServingModel (prefill +
    single-token decode), so the generation loop is engine-agnostic.
    Logits come back as numpy arrays, state stays on the model's device."""

    def __init__(self, srv):
        self._srv = srv
        self.n_vocab = srv.config.n_vocab

    def init_state(self):
        return self._srv.init_state(1)

    def eval_sequence_in_chunks(self, tokens, state=None):
        logits, st = self._srv.prefill(list(tokens), state)
        return host_logits(logits), st

    def eval(self, token, state):
        logits, st = self._srv.decode(np.asarray([token], np.int32), state)
        return host_logits(logits)[0], st


if __name__ == "__main__":
    main()
