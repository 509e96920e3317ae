"""Drop-in compatibility layer for code written against the reference's
Python bindings (rwkv.cpp's ``python/rwkv_cpp/``).

A port of ``rwkv_tpu.compat``. Mirrors the `rwkv_cpp` surface:

- `RWKVSharedLibrary` / `load_rwkv_shared_library` — no shared library is
  needed here (the engine is PyTorch); these exist so reference call sites
  (`RWKVModel(load_rwkv_shared_library(), path)`) work unchanged.
- `RWKVModel` — the reference's caller-owned-buffer API
  (rwkv_cpp_model.py): eval/eval_sequence/eval_sequence_in_chunks take and
  return FLAT state/logits arrays (numpy or torch CPU tensors), with the
  reference's validation semantics; state layout is byte-compatible
  (rwkv_tpu_torch/models/state.py). The model runs on `device` (default
  the CUDA card); the caller's buffers stay on the CPU.
- `rwkv_error_flags` / `RWKVError` — the error taxonomy of rwkv.h:38-62,
  surfaced as a typed exception instead of thread-local flags.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple, Union

import numpy as np

import torch

from rwkv_tpu_torch.models.model import RWKVModel as _CoreModel


# The quantized format names the reference binding layer advertises
# (rwkv_cpp_shared_library.py:8-16).
# All seven are fully supported, including the 256-element K-superblock
# formats Q4_K/Q5_K (io/quant.py codecs bit-matching ggml's reference
# quantizers; loader decomposes superblocks into per-32 affine
# sub-blocks, parity matmul consumes q8_K activations).
QUANTIZED_FORMAT_NAMES: Tuple[str, str, str, str, str, str, str] = (
    "Q4_0",
    "Q4_1",
    "Q4_K",
    "Q5_0",
    "Q5_1",
    "Q5_K",
    "Q8_0",
)


class rwkv_error_flags(enum.IntEnum):
    """Error categories of the reference C API (rwkv.h:38-62)."""

    RWKV_ERROR_NONE = 0
    RWKV_ERROR_ARGS = 1 << 8
    RWKV_ERROR_FILE = 2 << 8
    RWKV_ERROR_MODEL = 3 << 8
    RWKV_ERROR_MODEL_PARAMS = 4 << 8
    RWKV_ERROR_GRAPH = 5 << 8
    RWKV_ERROR_CTX = 6 << 8
    RWKV_ERROR_ALLOC = 1
    RWKV_ERROR_FILE_OPEN = 2
    RWKV_ERROR_FILE_STAT = 3
    RWKV_ERROR_FILE_READ = 4
    RWKV_ERROR_FILE_WRITE = 5
    RWKV_ERROR_FILE_VERSION = 6
    RWKV_ERROR_FILE_MAGIC = 7
    RWKV_ERROR_DATA_TYPE = 8
    RWKV_ERROR_UNSUPPORTED = 9
    RWKV_ERROR_SHAPE = 10
    RWKV_ERROR_DIMENSION = 11
    RWKV_ERROR_KEY = 12
    RWKV_ERROR_DATA = 13
    RWKV_ERROR_PARAM_MISSING = 14


class RWKVError(RuntimeError):
    def __init__(self, flags: rwkv_error_flags, message: str):
        super().__init__(message)
        self.flags = flags


class RWKVSharedLibrary:
    """Placeholder for the reference's ctypes wrapper — the PyTorch engine
    needs no shared object. Kept so reference call sites work unchanged."""

    def __init__(self, shared_library_path: str = ""):
        self.library_path = shared_library_path


def load_rwkv_shared_library() -> RWKVSharedLibrary:
    return RWKVSharedLibrary()


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


class RWKVModel:
    """Reference-shaped model wrapper (rwkv_cpp_model.py:22-364). `device`
    is where the model runs (default: the CUDA card; raises when there is
    none); `thread_count`, `gpu_layer_count` and `precision` are accepted
    and ignored, as in the JAX package."""

    def __init__(
        self,
        shared_library: Optional[RWKVSharedLibrary] = None,
        model_path: str = "",
        thread_count: int = 1,
        gpu_layer_count: int = 0,
        precision: str = "parity",
        device=None,
        **_kwargs,
    ):
        if isinstance(shared_library, str) and not model_path:
            # Allow RWKVModel('path') as well.
            model_path = shared_library
        if not model_path:
            raise RWKVError(rwkv_error_flags.RWKV_ERROR_ARGS, "model_path is required")
        try:
            self._model = _CoreModel(model_path, device=device)
        except FileNotFoundError as e:
            raise RWKVError(rwkv_error_flags.RWKV_ERROR_FILE_OPEN, str(e)) from e
        except ValueError as e:
            raise RWKVError(rwkv_error_flags.RWKV_ERROR_FILE, str(e)) from e
        self._valid = True

    # -- getters (rwkv.h) -------------------------------------------------
    @property
    def n_vocab(self) -> int:
        return self._model.n_vocab

    @property
    def n_embed(self) -> int:
        return self._model.n_embed

    @property
    def n_layer(self) -> int:
        return self._model.n_layer

    @property
    def _state_buffer_element_count(self) -> int:
        return self._model.state_len

    @property
    def _logits_buffer_element_count(self) -> int:
        return self._model.n_vocab

    # -- helpers ----------------------------------------------------------
    def _validate_buffer(self, buf, name: str, size: int):
        if _is_torch(buf):
            if buf.dtype != torch.float32:
                raise RWKVError(rwkv_error_flags.RWKV_ERROR_DATA_TYPE,
                                f"{name} must be float32")
            if not buf.is_contiguous():
                raise RWKVError(rwkv_error_flags.RWKV_ERROR_DATA,
                                f"{name} must be contiguous")
            if buf.device.type != "cpu":
                raise RWKVError(rwkv_error_flags.RWKV_ERROR_DATA,
                                f"{name} must be a CPU tensor")
            arr = buf.numpy()
        else:
            arr = np.asarray(buf)
            if arr.dtype != np.float32:
                raise RWKVError(rwkv_error_flags.RWKV_ERROR_DATA_TYPE,
                                f"{name} must be float32")
        if arr.size != size:
            raise RWKVError(rwkv_error_flags.RWKV_ERROR_SHAPE,
                            f"{name} has {arr.size} elements, expected {size}")
        return arr.reshape(-1)

    def _state_in(self, state_in):
        if state_in is None:
            return None
        flat = self._validate_buffer(state_in, "state_in", self._model.state_len)
        return self._model.state_from_flat(flat)

    def _pack(self, logits, state, state_out, logits_out, want_torch: bool):
        flat_state = self._model.state_to_flat(state)
        flat_logits = None if logits is None else logits.detach().to("cpu", torch.float32).numpy()
        if state_out is not None:
            dst = state_out.numpy() if _is_torch(state_out) else np.asarray(state_out)
            dst.reshape(-1)[:] = flat_state
        else:
            state_out = flat_state
        if flat_logits is not None:
            if logits_out is not None:
                dst = logits_out.numpy() if _is_torch(logits_out) else np.asarray(logits_out)
                dst.reshape(-1)[:] = flat_logits
            else:
                logits_out = flat_logits
        if want_torch:
            if not _is_torch(logits_out) and logits_out is not None:
                logits_out = torch.from_numpy(np.ascontiguousarray(logits_out))
            if not _is_torch(state_out):
                state_out = torch.from_numpy(np.ascontiguousarray(state_out))
        return logits_out, state_out

    # -- evaluation (reference signatures) --------------------------------
    def eval(
        self,
        token: int,
        state_in=None,
        state_out=None,
        logits_out=None,
        use_numpy: bool = True,
    ) -> Tuple[Union[np.ndarray, "object"], Union[np.ndarray, "object"]]:
        self._assert_valid()
        logits, state = self._model.eval(int(token), self._state_in(state_in))
        return self._pack(logits, state, state_out, logits_out, not use_numpy)

    def eval_sequence(
        self, tokens: List[int], state_in=None, state_out=None, logits_out=None,
        use_numpy: bool = True,
    ):
        self._assert_valid()
        logits, state = self._model.eval_sequence(tokens, self._state_in(state_in))
        return self._pack(logits, state, state_out, logits_out, not use_numpy)

    def eval_sequence_in_chunks(
        self, tokens: List[int], chunk_size: int = 16, state_in=None,
        state_out=None, logits_out=None, use_numpy: bool = True,
    ):
        self._assert_valid()
        logits, state = self._model.eval_sequence_in_chunks(
            tokens, chunk_size=chunk_size, state=self._state_in(state_in)
        )
        return self._pack(logits, state, state_out, logits_out, not use_numpy)

    def _assert_valid(self):
        if not self._valid:
            raise RWKVError(rwkv_error_flags.RWKV_ERROR_CTX, "model was freed")

    def free(self):
        """GC-safe free (rwkv_cpp_model.py:301-318): params are dropped and
        further use raises."""
        self._model = None
        self._valid = False


def get_system_info_string() -> str:
    """rwkv_get_system_info_string equivalent: reports the torch build and
    the CUDA devices instead of CPU SIMD features (rwkv.cpp:239-258)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    return (
        f"backend={'cuda' if n else 'cpu'} devices={n} [{', '.join(names)}] "
        f"torch={torch.__version__} cuda={torch.version.cuda}"
    )
