// Single-token GQA decode over a contiguous KV cache, for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/decode_attention.py: decode_attention /
// _decode_kernel. The gather caption engine reaches it through every decode
// step (T = 1) of the contiguous forward. The TPU kernel scalar-prefetched
// kv_len and ran a (row, kv head, kv block) grid that skipped blocks at or
// past kv_len, carrying m / l / acc in VMEM across the sequential kv axis.
// Here the keys of each (row, kv head) are cut into n_split ranges, one CTA
// each, and the last CTA to finish merges the partials in the same launch:
// split_decode.cuh's split-KV body with its ContiguousKV policy, the body
// paged decode runs too. Its query rows are the G grouped heads, so each
// K/V byte is read once for all of them. Precision is the TPU kernel's:
// q * sm_scale in fp32, fp32 logits, P and P V, acc / max(l, 1e-30).
//
// Bound on an H100 SXM (3.35 TB/s): 4 * G * D flops per visible key against
// 4 * D bytes of K and V, so it is bound by bytes, sum over rows of
// kv_len * Hkv * D * 4 / 3.35 TB/s. At the gather engine's B = 4 lane slots
// one CTA per (row, kv head) would be 32 CTAs on 132 SMs; the wrapper's
// split count (decode_split_count, as for paged decode) fills the card.
#include "split_decode.cuh"

extern "C" {

// q, out: [B, Hkv, G, D] bf16; k/v: [B, S, Hkv, D] bf16 with the new token
// already written; kv_len [B] int32. With n_split > 1: part_ml
// [B * Hkv * n_split * G * 2] and part_acc [B * Hkv * n_split * G * D] fp32
// scratch, counters [B * Hkv] int32 zeros (left zero); with one split they
// may be null.
int cct_decode(const void* q, const void* k, const void* v, const int* kv_len, void* out, float* part_ml,
               float* part_acc, int* counters, int B, int Hkv, int G, int D, int S, int n_split, float sm_scale,
               void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  const sdk::ContiguousKV kv{static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), S};
  const sdk::SplitParams p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), kv_len,
                           part_ml, part_acc, counters, G, n_split, sm_scale};
  return sdk::dispatch_split_decode(D, kv, p, B, Hkv, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
