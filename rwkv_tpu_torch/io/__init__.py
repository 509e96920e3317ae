"""ggmf model files and their block-quantization codecs: copies of
``rwkv_tpu.io``'s modules (numpy only)."""

from rwkv_tpu_torch.io.ggmf import (  # noqa: F401
    GgmfHeader,
    GgmfTensor,
    iter_ggmf_tensors,
    read_ggmf,
    read_ggmf_header,
    write_ggmf,
)
from rwkv_tpu_torch.io.quant import (  # noqa: F401
    QUANT_FORMATS,
    GgmlDType,
    dequantize_rows,
    quantize_rows,
    tensor_nbytes,
)
from rwkv_tpu_torch.io.quantize import quantize_model_file  # noqa: F401
