// Flash self-attention over [B, H, S, D], for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/flash_attention.py: flash_attention /
// _flash_kernel. The TPU kernel ran a (batch x heads, q tiles, kv tiles)
// grid whose innermost kv dimension ran in order and carried m / l / acc in
// VMEM scratch. Hopper CTAs run in parallel and carry nothing, so here one
// CTA owns 64 query rows of one (batch, head) and walks the 64-key tiles
// itself on the tensor-core body of tc_attention.cuh: a producer warp
// stages Q once and K / V tile by tile with TMA, and one consumer
// warpgroup runs S = Q K^T and O += P V as wgmma, with the online softmax
// in registers. The CTAs of one (batch, head) launch side by side, so its
// keys come from L2 after the first CTA's loads, and four CTAs per SM hide
// each other's load and epilogue latency.
//
// The policy (FlashCta): q / k / v are read through their strides (a
// [B, S, H, D] projection transposed to [B, H, S, D] is not copied; the
// tensor maps order s, h and b by stride), G = 1, keys at or past S are
// masked, and with `causal` keys after the query; key tiles above the
// diagonal are never loaded, query rows at or past S never stored, and the
// heaviest (last) query tiles launch first.
//
// Precision: the TPU kernel's fp32 scores times sm_scale and fp32 softmax;
// P is rounded to bf16 for the P V product (the TPU kernel and the plain
// version keep it in fp32), and O is divided by max(l, 1e-30) in fp32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * S^2 * D
// flops per (batch, head) against 8 * S * D bytes of bf16 q / k / v / out,
// S / 2 flops per byte: bound by bytes below S ~ 590 (the ViT's 197 tokens,
// the pooler's 9), by the operations above. The first version of this
// kernel computed on the CUDA cores in fp32 (67 TFLOP/s at most) from
// shared memory with synchronous loads; this one runs on the tensor cores
// with its loads overlapped by the TMA ring, so the bytes can bound it.
#include "tc_attention.cuh"

namespace {

// CTAs per SM the register budget is sized for: on the H100 four beat
// three, and one warpgroup per CTA beat two sharing each K / V tile (PERF.md)
constexpr int kMinBlocks = 4;
constexpr int kRows = tca::kRows;

struct FlashParams {
  __nv_bfloat16* out;
  long long ob, oh, os;   // out strides (elements); d is contiguous
  int H, S;
  int dim_s, dim_h, dim_b;  // tensor-map dimension (1..3) of s, h and b
  float scale;              // sm_scale * log2(e), on the fp32 scores
};

template <bool CAUSAL>
struct FlashCta {
  using Params = FlashParams;
  static constexpr bool kScaleQ = false;
  static constexpr bool kSplitP = false;
  static constexpr bool kWarpKV = false;
  static constexpr bool kCopyKV = false;
  const Params& p;
  int b, h, q0, key_end, q_rows;

  // a 1-d grid, query tiles fastest: the tiles sharing a (batch, head)'s
  // keys run side by side, each (batch, head) heaviest (last) tile first
  __device__ explicit FlashCta(const Params& prm) : p(prm), q_rows(kRows) {
    const int n_qt = (p.S + kRows - 1) / kRows;
    const int bh = blockIdx.x / n_qt;
    b = bh / p.H;
    h = bh % p.H;
    q0 = (n_qt - 1 - blockIdx.x % n_qt) * kRows;
    key_end = CAUSAL ? min(p.S, q0 + kRows) : p.S;
  }
  __device__ float q_scale() const { return 1.f; }
  __device__ float score_scale() const { return p.scale; }

  // coordinates (d0, row, h, b), placed in the tensor map's dimension order
  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int d0, int row) const {
    const int c1 = p.dim_s == 1 ? row : p.dim_h == 1 ? h : b;
    const int c2 = p.dim_s == 2 ? row : p.dim_h == 2 ? h : b;
    const int c3 = p.dim_s == 3 ? row : p.dim_h == 3 ? h : b;
    tca::tma_load_4d(dst, map, bar, d0, c1, c2, c3);
  }
  __device__ void load_q(const CUtensorMap* map, uint32_t dst, uint32_t bar, int d0) const {
    load(map, dst, bar, d0, q0);
  }
  __device__ void load_kv(const CUtensorMap* map, uint32_t dst, uint32_t bar, int d0, int key0) const {
    load(map, dst, bar, d0, key0);
  }
  __device__ tca::Row row(int r) const {
    const int s = q0 + r;
    const int kmax = CAUSAL ? min(s, p.S - 1) : p.S - 1;
    return {kmax, s < p.S ? p.out + b * p.ob + h * p.oh + s * p.os : nullptr};
  }
};

template <int D>
int launch_d(bool causal, const void* q, const void* k, const void* v, void* out, int B, int H,
             int S, long long sb, long long sh, long long ss, long long ob, long long oh,
             long long os, float sm_scale, cudaStream_t stream) {
  using Pn = tca::Panels<D>;
  // s, h and b in ascending stride for the tensor maps; a size-1 dim goes
  // last with a stride that follows from the one before it
  struct Dim {
    long long stride;
    long long size;
    int which;  // 0: s, 1: h, 2: b
  } dims[3] = {{ss, S, 0}, {sh, H, 1}, {sb, B, 2}};
  auto key = [](const Dim& d) { return d.size == 1 ? (1ll << 62) : d.stride; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(dims[j]) < key(dims[j - 1]); --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, 0, 0, 0}, gstride[3];
  cuuint32_t box_q[4] = {Pn::kW, 1, 1, 1}, box_kv[4] = {Pn::kW, 1, 1, 1};
  FlashParams p{static_cast<__nv_bfloat16*>(out), ob, oh, os, H, S, 0, 0, 0, sm_scale * tca::kLog2e};
  long long prev_bytes = 2ll * D;
  for (int i = 0; i < 3; ++i) {
    const Dim& d = dims[i];
    gdim[i + 1] = (cuuint64_t)d.size;
    const long long bytes = d.size == 1 ? prev_bytes : 2 * d.stride;
    gstride[i] = (cuuint64_t)bytes;
    prev_bytes = bytes * d.size;
    if (d.which == 0) {
      p.dim_s = i + 1;
      box_q[i + 1] = kRows;
      box_kv[i + 1] = tca::kBK;
    } else if (d.which == 1) {
      p.dim_h = i + 1;
    } else {
      p.dim_b = i + 1;
    }
  }
  CUtensorMap mq, mk, mv;
  int rc = tca::encode_map(&mq, q, 4, gdim, gstride, box_q, Pn::kRowBytes);
  if (rc == 0) rc = tca::encode_map(&mk, k, 4, gdim, gstride, box_kv, Pn::kRowBytes);
  if (rc == 0) rc = tca::encode_map(&mv, v, 4, gdim, gstride, box_kv, Pn::kRowBytes);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((long long)B * H * ((S + kRows - 1) / kRows)));
  return causal ? tca::launch<FlashCta<true>, D, kMinBlocks>(mq, mk, mv, p, grid, stream)
                : tca::launch<FlashCta<false>, D, kMinBlocks>(mq, mk, mv, p, grid, stream);
}

}  // namespace

extern "C" {

// q / k / v: bf16 [B, H, S, D] with strides (sb, sh, ss) in elements,
// multiples of 8, and a contiguous head dim; out: bf16 with strides
// (ob, oh, os). Returns a cudaError_t, or 10000 + the CUresult of a tensor
// map libcuda refused.
int cct_flash(const void* q, const void* k, const void* v, void* out, int B, int H, int S, int D,
              long long sb, long long sh, long long ss, long long ob, long long oh, long long os,
              int causal, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * ((S + kRows - 1) / kRows) > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(causal, q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, st);
    case 64:
      return launch_d<64>(causal, q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
