// Chunked-prefill GQA attention over a contiguous KV cache, for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/prefill_attention.py: prefill_attention /
// _prefill_kernel. The caption engine reaches it through every contiguous
// forward with T > 1, which in paged mode is the shared-prefix build
// (a pow2-padded prefix prefilled once into a scratch [1, S, Hkv, D] cache).
// The TPU kernel tiled block_q x block_k over a sequential grid with VMEM
// scratch; here one CTA owns 64 query rows of one (batch, kv head) and walks
// its K / V tiles on the tensor-core body of tc_attention.cuh (a TMA
// producer warp, one wgmma consumer warpgroup, the online softmax in
// registers).
//
// The policy (PrefillCta): the CTA's rows are block_q tokens x G grouped
// heads of q [B, T, Hkv, G, D] in (token, group) order, one 5-d TMA box
// (with G > 64 the groups split over CTAs, 64 at a time), so every K / V
// byte it stages serves all G heads of the group; K / V rows come from
// [B, S, Hkv, D]. Query t sits at write_index[b] + t and sees the keys at or
// before it and below kv_len[b]; key tiles past the CTA's last visible key
// are never loaded, the skip the TPU kernel made with pl.when. Rows of
// padded prefix tokens (t past kv_len) still compute, as in the plain
// version; rows past T are never stored. The heaviest query tiles (the last
// ones) launch first, and 64-row CTAs give the 1024-token prefix build 256
// CTAs, two per SM, rather than one partial wave.
//
// Precision: q * sm_scale rounded to bf16 as the plain version does (in
// shared memory, before any product), bf16 x bf16 scores in fp32, an fp32
// online softmax, and P V with P split into two bf16 parts (hi + lo), so
// the unnormalised probabilities enter at about fp32 as in the paged
// kernels: with P rounded to one bf16 part, the gather engine's greedy
// captions parted from the paged engine's on 2 of 8 requests.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at T = S = 1024
// the causal work is ~4 * Hq * D * T * S / 2 flops against a few MB of
// q / K / V / out, so the bound is the operations. The first version
// computed on the CUDA cores in fp32 from shared memory (two shared loads
// per FMA, four barriers per tile); this one runs the products on the
// tensor cores, with the next tile's loads in flight behind the math.
#include "tc_attention.cuh"

namespace {

// CTAs per SM the register budget is sized for: two CTAs of 80 KB of shared
// memory fit an SM at D = 128, and three spill at that width (PERF.md)
constexpr int kMinBlocks = 2;
constexpr int kRows = tca::kRows;

struct PrefillParams {
  __nv_bfloat16* out;  // [B, T, Hkv, G, D]
  const int* write_index;
  const int* kv_len;
  int T, Hkv, G, D, S;
  int gbox, block_q, n_gt;  // groups and tokens per CTA, group tiles per kv head
  float q_scale;            // sm_scale, applied to q in bf16
};

struct PrefillCta {
  using Params = PrefillParams;
  static constexpr bool kScaleQ = true;
  static constexpr bool kSplitP = true;
  static constexpr bool kWarpKV = false;
  static constexpr bool kCopyKV = false;
  const Params& p;
  int b, h, g0, t0, write, kvl, key_end, q_rows;

  __device__ explicit PrefillCta(const Params& prm) : p(prm) {
    b = blockIdx.z;
    h = blockIdx.x / p.n_gt;
    g0 = (blockIdx.x % p.n_gt) * p.gbox;
    t0 = (gridDim.y - 1 - blockIdx.y) * p.block_q;  // heaviest query tiles first
    write = p.write_index[b];
    kvl = min(p.kv_len[b], p.S);
    const int n_t = min(p.block_q, p.T - t0);
    key_end = max(0, min(kvl, write + t0 + n_t));
    q_rows = p.gbox * p.block_q;
  }
  __device__ float q_scale() const { return p.q_scale; }
  __device__ float score_scale() const { return tca::kLog2e; }

  // q map dims (D, G, Hkv, T, B), box (W, gbox, 1, block_q, 1)
  __device__ void load_q(const CUtensorMap* map, uint32_t dst, uint32_t bar, int d0) const {
    tca::tma_load_5d(dst, map, bar, d0, g0, h, t0, b);
  }
  // K / V map dims (D, Hkv, S, B), box (W, 1, kBK, 1)
  __device__ void load_kv(const CUtensorMap* map, uint32_t dst, uint32_t bar, int d0, int key0) const {
    tca::tma_load_4d(dst, map, bar, d0, h, key0, b);
  }
  __device__ tca::Row row(int r) const {
    const int t = t0 + r / p.gbox, g = g0 + r % p.gbox;
    const bool stored = r < q_rows && t < p.T && g < p.G;
    const long long off = ((((long long)b * p.T + t) * p.Hkv + h) * p.G + g) * p.D;
    return {min(kvl - 1, write + t), stored ? p.out + off : nullptr};
  }
};

template <int D>
int launch_d(const void* q, const void* k, const void* v, const int* write_index, const int* kv_len,
             void* out, int B, int T, int Hkv, int G, int S, float sm_scale, cudaStream_t stream) {
  using Pn = tca::Panels<D>;
  const int gbox = G < kRows ? G : kRows, block_q = kRows / gbox, n_gt = (G + gbox - 1) / gbox;
  const int n_qt = (T + block_q - 1) / block_q;
  if (n_qt > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const cuuint64_t e = 2;  // bytes per element
  const cuuint64_t qdim[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)Hkv, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t qstride[4] = {e * D, e * D * G, e * D * G * Hkv, e * D * G * Hkv * T};
  const cuuint32_t qbox[5] = {Pn::kW, (cuuint32_t)gbox, 1, (cuuint32_t)block_q, 1};
  const cuuint64_t kdim[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstride[3] = {e * D, e * D * Hkv, e * D * Hkv * S};
  const cuuint32_t kbox[4] = {Pn::kW, 1, tca::kBK, 1};
  CUtensorMap mq, mk, mv;
  int rc = tca::encode_map(&mq, q, 5, qdim, qstride, qbox, Pn::kRowBytes);
  if (rc == 0) rc = tca::encode_map(&mk, k, 4, kdim, kstride, kbox, Pn::kRowBytes);
  if (rc == 0) rc = tca::encode_map(&mv, v, 4, kdim, kstride, kbox, Pn::kRowBytes);
  if (rc != 0) return rc;
  const PrefillParams p{static_cast<__nv_bfloat16*>(out), write_index, kv_len, T, Hkv, G, D, S,
                        gbox, block_q, n_gt, sm_scale};
  const dim3 grid((unsigned)(Hkv * n_gt), (unsigned)n_qt, (unsigned)B);
  return tca::launch<PrefillCta, D, kMinBlocks>(mq, mk, mv, p, grid, stream);
}

}  // namespace

extern "C" {

// q, out: [B, T, Hkv, G, D] bf16; k/v: [B, S, Hkv, D] bf16 with the chunk
// already written at write_index; write_index / kv_len [B] int32. Returns a
// cudaError_t, or 10000 + the CUresult of a tensor map libcuda refused.
int cct_prefill(const void* q, const void* k, const void* v, const int* write_index,
                const int* kv_len, void* out, int B, int T, int Hkv, int G, int D, int S,
                float sm_scale, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || G < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(q, k, v, write_index, kv_len, out, B, T, Hkv, G, S, sm_scale, st);
    case 64:
      return launch_d<64>(q, k, v, write_index, kv_len, out, B, T, Hkv, G, S, sm_scale, st);
    case 128:
      return launch_d<128>(q, k, v, write_index, kv_len, out, B, T, Hkv, G, S, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
