"""Reader/writer for the `ggmf` RWKV model file format.

A copy of ``rwkv_tpu.io.ggmf``. Format (rwkv.cpp's docs/FILE_FORMAT.md and
rwkv_file_format.inc:102-213):

  file header:   6 x uint32 LE: magic 0x67676d66 ('ggmf'), version (100|101),
                 n_vocab, n_embed, n_layer, data_type (rwkv_type enum)
  tensor record: uint32 dim_count (1..3), uint32 key_length, uint32 data_type,
                 dim_count x uint32 sizes (innermost/contiguous dim first —
                 i.e. REVERSED relative to the numpy/PyTorch shape),
                 key_length bytes of utf-8 name, then raw tensor data.

We store each tensor's numpy shape in conventional (row-major, outermost
first) order; `sizes` on disk are written reversed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator

import numpy as np

from rwkv_tpu_torch.io.quant import GgmlDType, dequantize_rows, tensor_nbytes

GGMF_MAGIC = 0x67676D66
FILE_VERSION_0 = 100
FILE_VERSION_1 = 101

_HEADER_STRUCT = struct.Struct("<IIIIII")


@dataclass
class GgmfHeader:
    magic: int
    version: int
    n_vocab: int
    n_embed: int
    n_layer: int
    data_type: GgmlDType

    def validate(self) -> None:
        if self.magic != GGMF_MAGIC:
            raise ValueError(f"Bad magic 0x{self.magic:08x}, expected 0x{GGMF_MAGIC:08x}")
        if not (FILE_VERSION_0 <= self.version <= FILE_VERSION_1):
            raise ValueError(f"Unsupported file version {self.version}")


@dataclass
class GgmfTensor:
    name: str
    dtype: GgmlDType
    shape: tuple[int, ...]  # numpy order (outermost first)
    data: bytes = field(repr=False, default=b"")

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.dtype, *self.shape)

    def to_f32(self) -> np.ndarray:
        return dequantize_rows(np.frombuffer(self.data, dtype=np.uint8), self.dtype, self.shape)


def read_ggmf_header(f: BinaryIO) -> GgmfHeader:
    raw = f.read(_HEADER_STRUCT.size)
    if len(raw) != _HEADER_STRUCT.size:
        raise ValueError("Truncated ggmf header")
    magic, version, n_vocab, n_embed, n_layer, data_type = _HEADER_STRUCT.unpack(raw)
    header = GgmfHeader(magic, version, n_vocab, n_embed, n_layer, GgmlDType(data_type))
    header.validate()
    return header


def write_ggmf_header(f: BinaryIO, header: GgmfHeader) -> None:
    f.write(
        _HEADER_STRUCT.pack(
            header.magic,
            header.version,
            header.n_vocab,
            header.n_embed,
            header.n_layer,
            int(header.data_type),
        )
    )


def _read_tensor_record(f: BinaryIO, with_data: bool) -> GgmfTensor | None:
    head = f.read(12)
    if not head:
        return None
    if len(head) != 12:
        raise ValueError("Truncated tensor record header")
    dim_count, key_length, data_type = struct.unpack("<III", head)
    if dim_count not in (1, 2, 3):
        raise ValueError(f"Invalid tensor dim_count {dim_count}")
    sizes = struct.unpack(f"<{dim_count}I", f.read(4 * dim_count))
    name = f.read(key_length).decode("utf-8")
    shape = tuple(reversed(sizes))  # disk order is innermost-first
    dtype = GgmlDType(data_type)
    nbytes = tensor_nbytes(dtype, *shape)
    if with_data:
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(f"Truncated data for tensor {name!r}")
    else:
        f.seek(nbytes, 1)
        data = b""
    return GgmfTensor(name=name, dtype=dtype, shape=shape, data=data)


def iter_ggmf_tensors(f: BinaryIO, with_data: bool = True) -> Iterator[GgmfTensor]:
    while True:
        t = _read_tensor_record(f, with_data)
        if t is None:
            return
        yield t


def write_ggmf_tensor(f: BinaryIO, tensor: GgmfTensor) -> None:
    name_bytes = tensor.name.encode("utf-8")
    f.write(struct.pack("<III", len(tensor.shape), len(name_bytes), int(tensor.dtype)))
    for dim in reversed(tensor.shape):
        f.write(struct.pack("<I", dim))
    f.write(name_bytes)
    assert len(tensor.data) == tensor.nbytes, (
        f"{tensor.name}: data is {len(tensor.data)}B, expected {tensor.nbytes}B"
    )
    f.write(tensor.data)


def read_ggmf(path: str, with_data: bool = True) -> tuple[GgmfHeader, list[GgmfTensor]]:
    with open(path, "rb") as f:
        header = read_ggmf_header(f)
        tensors = list(iter_ggmf_tensors(f, with_data=with_data))
    return header, tensors


def write_ggmf(path: str, header: GgmfHeader, tensors: list[GgmfTensor]) -> None:
    with open(path, "wb") as f:
        write_ggmf_header(f, header)
        for t in tensors:
            write_ggmf_tensor(f, t)
