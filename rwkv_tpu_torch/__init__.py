"""PyTorch/CUDA port of the rwkv_tpu serving path for one NVIDIA H100.

Layout mirrors ``rwkv_tpu``: ``models/`` (config, state, synth, graph,
serve, and ``model``: the ggml-parity engine ``RWKVModel``), ``ops/``
(parity, kernels, chunked, megakernel, and the nvcc/ctypes builder
``_cuda``), ``csrc/`` (hand-written CUDA C++ for sm_90a), ``compat`` (the
reference bindings' surface), ``utils/`` (sampling, tokenizers),
``tools/`` (the CLI tools), ``reservoir/`` (reservoir computing on the
models), ``utils/profiling`` and ``native`` (the g++-built host library:
file quantization, the World trie tokenizer). The package imports torch
and numpy only; it never imports jax or rwkv_tpu. ``RWKVModel``,
``ServingModel``, ``ContinuousBatcher``, ``ReservoirRWKV``,
``ModelConfig`` and ``get_tokenizer`` resolve lazily from the top level.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper takes its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""


def __getattr__(name):
    # Lazy imports, as in rwkv_tpu: `import rwkv_tpu_torch` stays light.
    if name == "RWKVModel":
        from rwkv_tpu_torch.models.model import RWKVModel

        return RWKVModel
    if name == "ServingModel":
        from rwkv_tpu_torch.models.serve import ServingModel

        return ServingModel
    if name == "ContinuousBatcher":
        from rwkv_tpu_torch.parallel.batching import ContinuousBatcher

        return ContinuousBatcher
    if name == "ReservoirRWKV":
        from rwkv_tpu_torch.reservoir import ReservoirRWKV

        return ReservoirRWKV
    if name == "ModelConfig":
        from rwkv_tpu_torch.models.config import ModelConfig

        return ModelConfig
    if name == "get_tokenizer":
        from rwkv_tpu_torch.utils.tokenizer import get_tokenizer

        return get_tokenizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
