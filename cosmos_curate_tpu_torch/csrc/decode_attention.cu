// Single-token GQA decode over a contiguous KV cache, for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/decode_attention.py: decode_attention /
// _decode_kernel. The gather caption engine reaches it through every decode
// step (T = 1) of the contiguous forward. The TPU kernel scalar-prefetched
// kv_len and ran a (row, kv head, kv block) grid that skipped blocks at or
// past kv_len, carrying m / l / acc in VMEM across the sequential kv axis.
// Here one CTA per (row, kv head) walks the K/V tiles below kv_len itself:
// the ContiguousKV policy of chunk_attention.cuh, whose query rows are the
// G grouped heads, so each K/V byte is read once for all of them. Precision is the TPU kernel's: q * sm_scale in fp32, fp32
// logits, P and P V, acc / max(l, 1e-30).
//
// Bound on an H100 SXM (3.35 TB/s): 4 * G * D flops per visible key against
// 4 * D bytes of K and V, so it is bound by bytes, sum over rows of
// kv_len * Hkv * D * 4 / 3.35 TB/s. At the gather engine's B = 4 lane slots
// the launch is only B * Hkv = 32 CTAs on 132 SMs; the split-KV body of
// paged decode (split_decode.cuh) would fill it.
#include "chunk_attention.cuh"

namespace {

constexpr int kTileK = 128;
constexpr int kRows = 16;  // G <= 16
constexpr int kThreads = 128;

}  // namespace

extern "C" {

// q, out: [B, Hkv, G, D] bf16; k/v: [B, S, Hkv, D] bf16 with the new token
// already written; kv_len [B] int32.
int cct_decode(const void* q, const void* k, const void* v, const int* kv_len, void* out, int B,
               int Hkv, int G, int D, int S, float sm_scale, void* stream) {
  cct::ContiguousKV kv{static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                       S, Hkv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return cct::launch_chunk_attention<16, kTileK, kRows, kThreads>(q, out, kv, kv_len, B, Hkv,
                                                                    G, sm_scale, st);
    case 64:
      return cct::launch_chunk_attention<64, kTileK, kRows, kThreads>(q, out, kv, kv_len, B, Hkv,
                                                                    G, sm_scale, st);
    case 128:
      return cct::launch_chunk_attention<128, kTileK, kRows, kThreads>(q, out, kv, kv_len, B, Hkv,
                                                                    G, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
