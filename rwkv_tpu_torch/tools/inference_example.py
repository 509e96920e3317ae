"""Minimal canonical use of the API: load a model, prefill a prompt, sample
a short continuation.

    python -m rwkv_tpu_torch.tools.inference_example MODEL [TOKENIZER]
        [--prompt TEXT] [--length N] [--device cpu]

A port of ``rwkv_tpu.tools.inference_example`` (the reference's
python/inference_example.py). The model runs on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse

import numpy as np

from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.utils.sampling import sample_logits
from rwkv_tpu_torch.utils.tokenizer import add_tokenizer_argument, get_tokenizer


def main(argv=None):
    p = argparse.ArgumentParser(description="Minimal inference example")
    p.add_argument("model_path")
    add_tokenizer_argument(p)
    p.add_argument("--prompt", default="In a shocking finding,")
    p.add_argument("--length", type=int, default=32)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    model = RWKVModel(args.model_path, device=args.device)
    decode, encode = get_tokenizer(args.tokenizer, model.n_vocab)

    logits, state = model.eval_sequence_in_chunks(encode(args.prompt))
    print(args.prompt, end="")
    rng = np.random.default_rng(0)
    for _ in range(args.length):
        token = sample_logits(logits, temperature=0.8, top_p=0.5, rng=rng)
        print(decode([token]), end="", flush=True)
        logits, state = model.eval(token, state)
    print()


if __name__ == "__main__":
    main()
