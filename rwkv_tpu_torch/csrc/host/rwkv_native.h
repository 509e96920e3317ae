/* Native host-side data plane: ggmf file I/O, block quantization, and the
 * World trie tokenizer.
 *
 * The port's own copy of the JAX package's native library (native/): the
 * reference engine's file format, quantizer (rwkv_file_format.inc,
 * rwkv_quantize.inc) and byte-trie tokenizer, for the CPU-bound paths
 * around the model: file parsing, streaming requantization and
 * tokenization. Exposed as a C ABI consumed from Python via ctypes
 * (rwkv_tpu_torch/native.py), byte-exact with the pure-Python
 * implementations (tests/test_torch_native.py).
 */

#ifndef RWKV_NATIVE_H
#define RWKV_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#ifdef _WIN32
#define RWKV_NATIVE_API __declspec(dllexport)
#else
#define RWKV_NATIVE_API __attribute__((visibility("default")))
#endif

/* ---- error handling ---- */
RWKV_NATIVE_API const char *rwkv_native_last_error(void);

/* ---- ggmf file inspection ---- */
typedef struct {
    uint32_t magic;
    uint32_t version;
    uint32_t n_vocab;
    uint32_t n_embed;
    uint32_t n_layer;
    uint32_t data_type;
} rwkv_ggmf_header;

typedef struct {
    char     name[128];
    uint32_t dtype;
    uint32_t n_dims;
    uint32_t shape[4];   /* row-major (outermost first), like numpy */
    uint64_t offset;     /* byte offset of tensor data in the file */
    uint64_t nbytes;     /* packed data size */
} rwkv_ggmf_tensor_info;

/* Read the header; returns 0 on success. */
RWKV_NATIVE_API int rwkv_ggmf_read_header(const char *path, rwkv_ggmf_header *out);

/* Scan the tensor table. Pass infos=NULL to count tensors; returns the
 * number of tensors, or -1 on error. */
RWKV_NATIVE_API int64_t rwkv_ggmf_scan(const char *path,
                                       rwkv_ggmf_tensor_info *infos,
                                       int64_t max_infos);

/* ---- block quantization codecs (32-element blocks, ggml formats) ----
 * dtype ids follow the on-disk rwkv_type enum: 0=F32 1=F16 2=Q4_0 3=Q4_1
 * 7=Q5_0 8=Q5_1 9=Q8_0. All return 0 on success. */
RWKV_NATIVE_API int64_t rwkv_quant_row_size(uint32_t dtype, int64_t n_elems);

RWKV_NATIVE_API int rwkv_quantize_block_data(uint32_t dtype, const float *src,
                                             uint8_t *dst, int64_t n_elems,
                                             int n_threads);

RWKV_NATIVE_API int rwkv_dequantize_block_data(uint32_t dtype, const uint8_t *src,
                                               float *dst, int64_t n_elems,
                                               int n_threads);

/* Streaming file-to-file requantization (native equivalent of
 * rwkv_quantize_model_file + extras/quantize.c). Applies the reference's
 * skip-list semantics. Returns 0 on success; sizes out params optional. */
RWKV_NATIVE_API int rwkv_quantize_model_file(const char *in_path,
                                             const char *out_path,
                                             uint32_t target_dtype,
                                             int n_threads,
                                             uint64_t *orig_bytes,
                                             uint64_t *new_bytes);

/* ---- World trie tokenizer ---- */
typedef struct rwkv_trie_tokenizer rwkv_trie_tokenizer;

RWKV_NATIVE_API rwkv_trie_tokenizer *rwkv_tokenizer_init(const char *vocab_path);
RWKV_NATIVE_API void rwkv_tokenizer_free(rwkv_trie_tokenizer *tok);

/* Greedy longest-match encode. Returns token count, or -1 on error
 * (untokenizable byte / out buffer too small). */
RWKV_NATIVE_API int64_t rwkv_tokenizer_encode(rwkv_trie_tokenizer *tok,
                                              const uint8_t *text, int64_t text_len,
                                              int32_t *out_tokens, int64_t max_tokens);

/* Decode to bytes. Returns byte count, or -1 on error. */
RWKV_NATIVE_API int64_t rwkv_tokenizer_decode(rwkv_trie_tokenizer *tok,
                                              const int32_t *tokens, int64_t n_tokens,
                                              uint8_t *out, int64_t max_out);

#ifdef __cplusplus
}
#endif

#endif /* RWKV_NATIVE_H */
