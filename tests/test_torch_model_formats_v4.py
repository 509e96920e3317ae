"""The port's parity engine against the JAX package's ``RWKVModel`` on
RWKV v4.0 synth files in every format (FP32, FP16, Q4_0, Q4_1, Q5_0,
Q5_1, Q8_0, Q4_K, Q5_K): chunked prefill, logits and state within the
bands of ``test_torch_model_api.py`` (quantized: equal argmax)."""

import pytest

from test_torch_model_api import FORMATS, check_file


@pytest.mark.parametrize("fmt", FORMATS)
def test_file_matches_jax(tmp_path_factory, fmt):
    check_file(tmp_path_factory, "4.0", fmt)
