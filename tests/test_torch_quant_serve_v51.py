"""``ServingModel`` on RWKV v5.1 synth files against the JAX package, on
the CPU: every file format under ``quant``, ``q8``, ``q8r`` against
JAX's XLA path, and the decode kernels' pack of a Q5_1 file, through the
``check_*`` functions and bands of ``test_torch_quant_serve.py``."""

import pytest

from test_torch_quant_serve import (
    FILE_FORMATS, check_megakernel_pack, check_q8, check_q8r_xla, check_quantized_file, fp32_file,
    one_torch_thread,  # noqa: F401 (autouse)
)

VERSION = "5.1"


@pytest.fixture(scope="module")
def fp32(tmp_path_factory):
    return fp32_file(tmp_path_factory, VERSION)


@pytest.mark.parametrize("fmt", FILE_FORMATS)
def test_serving_model_on_a_quantized_file_matches_jax(fp32, tmp_path, fmt):
    check_quantized_file(fp32, tmp_path, fmt)


def test_q8_matches_jax():
    check_q8(VERSION)


def test_q8r_within_band_of_jax_xla_path():
    check_q8r_xla(VERSION)


def test_megakernel_pack_of_a_quantized_file_bit_equal_jax(fp32, tmp_path):
    check_megakernel_pack(fp32, tmp_path)
