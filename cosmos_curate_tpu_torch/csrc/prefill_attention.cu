// Chunked-prefill GQA attention over a contiguous KV cache, for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/prefill_attention.py: prefill_attention /
// _prefill_kernel. The caption engine reaches it through every contiguous
// forward with T > 1, which in paged mode is the shared-prefix build
// (a pow2-padded prefix prefilled once into a scratch [1, S, Hkv, D] cache).
// The TPU kernel tiled block_q x block_k over a sequential grid with VMEM
// scratch; here one CTA per (q-tile, kv head, row) loops over K/V tiles
// itself (ContiguousKV policy of chunk_attention.cuh), skipping tiles past
// the tile's last causal position or kv_len exactly as the TPU kernel did.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at T = S = 1024
// the causal work is ~4 * Hq * D * T * S / 2 flops against a few MB of
// q / K / V / out, so the bound is the operations. This version computes
// on the CUDA cores in fp32 from shared-memory tiles, far from that bound;
// a wgmma / TMA pipeline is the next step.
#include "chunk_attention.cuh"

namespace {

constexpr int kTileK = 64;
constexpr int kRows = 128;  // block_q = 128 / G tokens per CTA
constexpr int kThreads = 256;

}  // namespace

extern "C" {

// q, out: [B, T, Hkv, G, D] bf16; k/v: [B, S, Hkv, D] bf16 with the chunk
// already written at write_index; write_index / kv_len [B] int32.
int cct_prefill(const void* q, const void* k, const void* v, const int* write_index,
                const int* kv_len, void* out, int B, int T, int Hkv, int G, int D, int S,
                float sm_scale, void* stream) {
  cct::ContiguousKV kv{static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                       S, Hkv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return cct::launch_chunk_attention<16, kTileK, kRows, kThreads>(
          q, out, kv, write_index, kv_len, B, T, Hkv, G, sm_scale, st);
    case 64:
      return cct::launch_chunk_attention<64, kTileK, kRows, kThreads>(
          q, out, kv, write_index, kv_len, B, T, Hkv, G, sm_scale, st);
    case 128:
      return cct::launch_chunk_attention<128, kTileK, kRows, kThreads>(
          q, out, kv, write_index, kv_len, B, T, Hkv, G, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
