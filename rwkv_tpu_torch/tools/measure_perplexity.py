"""Measure perplexity of a model on a text file.

    python -m rwkv_tpu_torch.tools.measure_perplexity MODEL TEXT [TOKENIZER]
        [--ignore-first-n-tokens N] [--serve PRECISION [--megakernel]]
        [--device cpu]

A port of ``rwkv_tpu.tools.measure_perplexity`` (parity with the
reference's python/measure_pexplexity.py): exp(mean cross-entropy) over
the file's tokens, conditioning each on the full prefix; reports
per-token latency. The parity engine by default, or with ``--serve`` the
port's ``ServingModel`` at that precision. The model runs on the CUDA card
unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rwkv_tpu_torch.tools.generate_completions import load_model
from rwkv_tpu_torch.utils.sampling import host_logits, softmax
from rwkv_tpu_torch.utils.tokenizer import add_tokenizer_argument, get_tokenizer


def measure_perplexity(
    model,
    tokens: list[int],
    ignore_first_n: int = 0,
) -> tuple[float, float]:
    """Returns (perplexity, latency_ms_per_token). Cross-entropy is measured
    on every token after `ignore_first_n`, conditioning on the full prefix
    (RWKV state is O(1), so no context cap is needed); the tokens go one at
    a time."""
    if len(tokens) <= ignore_first_n + 1:
        raise ValueError(f"need more than {ignore_first_n + 1} tokens, got {len(tokens)}")
    loss_sum = 0.0
    n_loss = 0
    state = model.init_state()
    logits = None
    t0 = time.perf_counter()
    for i, tok in enumerate(tokens):
        if i >= ignore_first_n and logits is not None:
            probs = softmax(host_logits(logits))
            loss_sum += -float(np.log(max(probs[tok], 1e-30)))
            n_loss += 1
        logits, state = model.eval(tok, state)
    dt = time.perf_counter() - t0
    ppl = float(np.exp(loss_sum / max(n_loss, 1)))
    return ppl, dt * 1000.0 / len(tokens)


def main(argv=None):
    p = argparse.ArgumentParser(description="Measure perplexity over a text file")
    p.add_argument("model_path")
    p.add_argument("text_path")
    add_tokenizer_argument(p)
    p.add_argument("--ignore-first-n-tokens", type=int, default=0)
    p.add_argument(
        "--serve", default=None, metavar="PRECISION",
        help="measure the THROUGHPUT engine at this serving precision "
             "(bf16/q8/q8r/w8a8/w4a8/quant) instead of the parity engine",
    )
    p.add_argument(
        "--megakernel", action="store_true",
        help="with --serve: route decode through the whole-model kernel",
    )
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    model = load_model(args.model_path, args.serve, args.megakernel, args.device)
    _, encode = get_tokenizer(args.tokenizer, model.n_vocab)
    with open(args.text_path, "r", encoding="utf-8") as f:
        tokens = encode(f.read())
    print(f"{len(tokens)} tokens")

    ppl, ms = measure_perplexity(model, tokens, args.ignore_first_n_tokens)
    print(f"Perplexity: {ppl:.3f}")
    print(f"Latency: {ms:.2f} ms per token")


if __name__ == "__main__":
    main()
