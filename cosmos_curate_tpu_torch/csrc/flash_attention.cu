// Flash self-attention over [B, H, S, D], for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/flash_attention.py: flash_attention /
// _flash_kernel. The TPU kernel ran a (batch x heads, q tiles, kv tiles)
// grid whose innermost kv dimension ran in order and carried m / l / acc in
// VMEM scratch. Hopper CTAs run in parallel and carry nothing, so here one
// CTA owns one (batch x head, 64-row query tile) and loops over the 64-row
// key tiles itself, keeping the online-softmax state in registers:
//   1. stage q * sm_scale (fp32) transposed in shared memory, once;
//   2. per key tile: stage K transposed and V as fp32 (16-byte loads, rows
//      at or past S zero-filled), then S = q k^T on a 16 x 16 thread grid,
//      each thread a 4 x 4 register tile (two float4 shared reads per 16
//      FMAs);
//   3. keys at or past S, and with `causal` keys after the query, are
//      masked to -1e30; the row max and sum reduce over the 16 lanes that
//      share a row; m, l and the rescale live in registers;
//   4. acc = acc * alpha + P V, P through shared memory, each thread owning
//      4 query rows x D/16 head dims.
// With `causal`, key tiles above the diagonal are never loaded, and query
// rows at or past S are never stored. Precision is the TPU kernel's: fp32
// q * scale, fp32 logits and softmax, fp32 P V, acc / max(l, 1e-30).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * S^2 * D
// flops per (batch, head) against 8 * S * D bytes of bf16 q / k / v / out,
// S / 2 flops per byte: bound by bytes below S ~ 590 (the ViT's 197 tokens,
// the pooler's 9), by the operations above. This version computes on the
// CUDA cores in fp32 (67 TFLOP/s at most) from shared memory; wgmma with
// TMA staging is the step towards either bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns query rows 4ty.., tx key columns 4tx..
constexpr int kPLd = kBK + 4;  // P row stride in floats: float4 aligned, rows 4 apart in banks
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  // q^T [D][kBQ], K^T [D][kBK], V [kBK][D], P [kBQ][kPLd]
  return D * kBQ + D * kBK + kBK * D + kBQ * kPLd;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N consecutive floats from shared memory, in the widest aligned loads
template <int N>
__device__ __forceinline__ void load_floats(const float* src, float (&dst)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + e);
      dst[e] = t.x, dst[e + 1] = t.y, dst[e + 2] = t.z, dst[e + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + e);
      dst[e] = t.x, dst[e + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = src[e];
  }
}

// Rows [row0, row0 + kBK) of one (batch, head) plane, 16 bytes at a time, as
// fp32: transposed into dst[d * ld + r] or row-major dst[r * D + d]. Rows at
// or past S are zero.
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* plane, long long row_stride,
                                           int row0, int S, float scale, float* dst, int ld) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < kBK * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) raw = *reinterpret_cast<const uint4*>(plane + (row0 + r) * row_stride + c);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __bfloat162float(x[e]) * scale;
      if constexpr (TRANSPOSE) {
        dst[(c + e) * ld + r] = f;
      } else {
        dst[r * D + c + e] = f;
      }
    }
  }
}

// q / k / v share strides (elements) over (b, h, s); d is contiguous. out has
// its own. Grid: one CTA per (q tile, b * H + h), q tiles fastest.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H, int S,
    long long sb, long long sh, long long ss, long long ob, long long oh, long long os,
    float sm_scale) {
  static_assert(kBQ == kBK && kBQ == 64, "the 16 x 16 thread grid covers 64 x 64 tiles");
  static_assert(D % 16 == 0, "16 threads split the head dim");
  constexpr int VD = D / 16;  // head dims per thread in P V
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;
  float* kT = qT + D * kBQ;
  float* vs = kT + D * kBK;
  float* ps = vs + kBK * D;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q_tile = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int q0 = q_tile * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long in_off = b * sb + h * sh;

  stage_rows<D, true>(q + in_off, ss, q0, S, sm_scale, qT, kBQ);

  float m[4], l[4], acc[4][VD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VD; ++e) acc[i][e] = 0.f;
  }

  // keys this tile can see: all of S, or with causal up to its last query
  const int k_end = CAUSAL ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with kT / vs / ps
    stage_rows<D, true>(k + in_off, ss, k0, S, 1.f, kT, kBK);
    stage_rows<D, false>(v + in_off, ss, k0, S, 1.f, vs, 0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kBQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * kBK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + 4 * tx + j;
        const bool seen = k_pos < S && (!CAUSAL || k_pos <= q_pos);
        s[i][j] = seen ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < VD; ++e) acc[i][e] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kPLd + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kPLd + j);
        p[i][0] = t.x, p[i][1] = t.y, p[i][2] = t.z, p[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[VD];
        load_floats<VD>(vs + (j + jj) * D + tx * VD, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[i][e] = fmaf(p[i][jj], vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r < S) {
      __nv_bfloat16* dst = out + b * ob + h * oh + r * os + tx * VD;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < VD; ++e) dst[e] = __float2bfloat16(acc[i][e] / denom);
    }
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
           long long sb, long long sh, long long ss, long long ob, long long oh, long long os,
           float sm_scale, cudaStream_t stream) {
  auto kernel = flash_kernel<D, CAUSAL>;
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  static unsigned long long configured = 0;  // one bit per device
  if (!(configured & (1ull << device))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << device;
  }
  const long long ctas = (long long)B * H * ((S + kBQ - 1) / kBQ);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, S, sb, sh, ss,
      ob, oh, os, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int causal, const void* q, const void* k, const void* v, void* out, int B, int H,
             int S, long long sb, long long sh, long long ss, long long ob, long long oh,
             long long os, float sm_scale, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, stream)
                : launch<D, false>(q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, stream);
}

}  // namespace

extern "C" {

// q / k / v: bf16 [B, H, S, D] with strides (sb, sh, ss) in elements and a
// contiguous head dim; out: bf16 with strides (ob, oh, os).
int cct_flash(const void* q, const void* k, const void* v, void* out, int B, int H, int S, int D,
              long long sb, long long sh, long long ss, long long ob, long long oh, long long os,
              int causal, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(causal, q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, st);
    case 64:
      return launch_d<64>(causal, q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, st);
    case 96:
      return launch_d<96>(causal, q, k, v, out, B, H, S, sb, sh, ss, ob, oh, os, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
