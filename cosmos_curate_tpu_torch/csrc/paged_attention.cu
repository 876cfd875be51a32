// Paged GQA attention read through the block table (decode and chunked
// prefill), for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/paged_attention.py:
//   - cct_paged_decode  <- _paged_decode / _paged_decode_kernel (T = 1)
//   - cct_paged_prefill <- _paged_prefill / _paged_prefill_kernel (T > 1)
// The TPU kernels put the block table in scalar prefetch and let the
// BlockSpec index map fetch pool block table[b, j] per grid step, carrying
// m / l / acc in VMEM scratch across the sequential grid. Hopper CTAs run in
// parallel and carry nothing between them, so here each CTA loops over the
// K/V tiles itself and keeps the softmax state on chip; the table lookup is
// the PagedKV policy of chunk_attention.cuh. The TPU's g_pad = max(8, G)
// sublane padding is not carried over: rows are exactly block_q * G.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): decode reads
// each visible K/V row once per (row, kv head), 2 * kv_len * D * 2 bytes,
// against 4 * G * kv_len * D flops, so it is bound by bytes
// (sum over rows of KV bytes / 3.35 TB/s). Prefill chunks of T = 64..256
// tokens do ~G * T flops per K/V byte pair and sit near the bf16 ridge.
// This first version stages K/V tiles in shared memory with 16-byte loads
// and computes on the CUDA cores; at base width decode launches only
// B * Hkv = 32..64 CTAs on 132 SMs, so split-KV decode and wgmma prefill
// are the next steps.
#include "chunk_attention.cuh"

namespace {

constexpr int kDecodeTileK = 128;
constexpr int kDecodeRows = 16;  // G <= 16
constexpr int kDecodeThreads = 128;
constexpr int kPrefillTileK = 64;
constexpr int kPrefillRows = 128;  // block_q = 128 / G tokens per CTA
constexpr int kPrefillThreads = 256;

template <int TILE_K, int MAX_ROWS, int NT>
int paged_dispatch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* write_index, const int* kv_len, void* out, int B, int T, int Hkv,
                   int G, int D, int nbl, int bs, float sm_scale, cudaStream_t stream) {
  cct::PagedKV kv{static_cast<const __nv_bfloat16*>(k_pool),
                  static_cast<const __nv_bfloat16*>(v_pool), tables, nbl, bs, Hkv};
  switch (D) {
    case 16:
      return cct::launch_chunk_attention<16, TILE_K, MAX_ROWS, NT>(
          q, out, kv, write_index, kv_len, B, T, Hkv, G, sm_scale, stream);
    case 64:
      return cct::launch_chunk_attention<64, TILE_K, MAX_ROWS, NT>(
          q, out, kv, write_index, kv_len, B, T, Hkv, G, sm_scale, stream);
    case 128:
      return cct::launch_chunk_attention<128, TILE_K, MAX_ROWS, NT>(
          q, out, kv, write_index, kv_len, B, T, Hkv, G, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: [B, 1, Hkv, G, D] bf16; k_pool/v_pool: one layer's pool
// [NB, bs, Hkv, D] bf16; tables [B, nbl], write_index / kv_len [B] int32.
int cct_paged_decode(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                     const int* write_index, const int* kv_len, void* out, int B, int Hkv, int G,
                     int D, int nbl, int bs, float sm_scale, void* stream) {
  return paged_dispatch<kDecodeTileK, kDecodeRows, kDecodeThreads>(
      q, k_pool, v_pool, tables, write_index, kv_len, out, B, 1, Hkv, G, D, nbl, bs, sm_scale,
      static_cast<cudaStream_t>(stream));
}

// q, out: [B, T, Hkv, G, D] bf16; otherwise as cct_paged_decode.
int cct_paged_prefill(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                      const int* write_index, const int* kv_len, void* out, int B, int T,
                      int Hkv, int G, int D, int nbl, int bs, float sm_scale, void* stream) {
  return paged_dispatch<kPrefillTileK, kPrefillRows, kPrefillThreads>(
      q, k_pool, v_pool, tables, write_index, kv_len, out, B, T, Hkv, G, D, nbl, bs, sm_scale,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
