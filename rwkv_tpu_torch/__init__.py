"""PyTorch/CUDA port of the rwkv_tpu serving path for one NVIDIA H100.

Layout mirrors ``rwkv_tpu``: ``models/`` (config, state, synth, graph,
serve, and ``model``: the ggml-parity engine ``RWKVModel``), ``ops/``
(parity, kernels, chunked, megakernel, and the nvcc/ctypes builder
``_cuda``), ``csrc/`` (hand-written CUDA C++ for sm_90a), ``compat`` (the
reference bindings' surface), ``utils/`` (sampling, tokenizers) and
``tools/`` (the CLI tools). The package imports torch and numpy only; it
never imports jax or rwkv_tpu.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper takes its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""
