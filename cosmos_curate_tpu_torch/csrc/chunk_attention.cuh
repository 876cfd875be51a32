// Device body of the port's contiguous decode kernel (cct_decode,
// csrc/decode_attention.cu): one token per row of grouped (GQA) queries
// against a [B, S, Hkv, D] cache with an fp32 online softmax. (Paged decode
// runs on split_decode.cuh; the prefill and flash kernels on the
// tensor-core body, tc_attention.cuh.)
//
// One CTA owns one (row, kv head). Its query rows are the G grouped heads,
// so every K/V byte it stages serves all of them. The CTA walks the keys
// below kv_len in TILE_K-row tiles:
//   1. stage the tile's K and V rows in shared memory as fp32 (16-byte
//      loads; rows at or past kv_len are zero-filled);
//   2. scores S[g][j] = q_g . k_j, masked to -1e30 past kv_len;
//   3. online softmax, one warp per row: m, l and the rescale factor live
//      in shared memory;
//   4. acc = acc * alpha + P V, each thread owning fixed (row, dim)
//      accumulators in registers.
// Tiles at or past kv_len are never loaded, the skip the TPU kernel makes
// with pl.when. Precision is the TPU decode kernel's: q * sm_scale in fp32,
// fp32 scores, P and P V, acc / max(l, 1e-30).
//
// Scores and P.V run on the CUDA cores in fp32 (two shared-memory reads per
// FMA), one CTA per (row, kv head): split_decode.cuh's split-KV body is the
// next step for this kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cct {

constexpr float kNegInf = -1e30f;

struct ContiguousKV {
  const __nv_bfloat16* k;  // [B, S, Hkv, D]
  const __nv_bfloat16* v;
  int s;
  int hkv;
  __device__ __forceinline__ int rows() const { return s; }
  __device__ __forceinline__ int64_t row_offset(int b, int p, int h, int d) const {
    return (((int64_t)b * s + p) * hkv + h) * d;
  }
};

template <int D, int TILE_K, int MAX_ROWS>
constexpr int chunk_smem_floats() {
  // q [MAX_ROWS][D], K [TILE_K][D + 1] (padded: conflict-free column reads),
  // V [TILE_K][D], S/P [MAX_ROWS][TILE_K], m / l / alpha [MAX_ROWS]
  return MAX_ROWS * D + TILE_K * (D + 1) + TILE_K * D + MAX_ROWS * TILE_K + 3 * MAX_ROWS;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q, out: [B, Hkv, G, D] bf16. Grid (1, Hkv, B), NT threads.
template <int D, int TILE_K, int MAX_ROWS, int NT, class KV>
__global__ void __launch_bounds__(NT) chunk_attention_kernel(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, KV kv,
    const int* __restrict__ kv_len, int G, float sm_scale) {
  static_assert(D % 8 == 0, "16-byte K/V loads need D % 8 == 0");
  static_assert(TILE_K % 32 == 0 && NT % 32 == 0, "warp-shaped tiles");
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + MAX_ROWS * D;
  float* v_s = k_s + TILE_K * (D + 1);
  float* s_s = v_s + TILE_K * D;
  float* m_s = s_s + MAX_ROWS * TILE_K;
  float* l_s = m_s + MAX_ROWS;
  float* a_s = l_s + MAX_ROWS;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = gridDim.y;
  const int tid = threadIdx.x;
  const int rows = G;  // <= MAX_ROWS (checked by the launcher)
  // keys this CTA can see: written (< kv_len) and inside the cache
  const int limit = min(kv_len[b], kv.rows());
  const int64_t row0 = ((int64_t)b * hkv + h) * G * D;

  // queries, scaled in fp32 as the TPU decode kernel
  for (int i = tid; i < rows * D; i += NT) q_s[i] = __bfloat162float(q[row0 + i]) * sm_scale;
  for (int r = tid; r < rows; r += NT) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  constexpr int ACC = (MAX_ROWS * D + NT - 1) / NT;
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int k0 = 0; k0 < limit; k0 += TILE_K) {
    constexpr int VEC = 8;  // bf16 per 16-byte load
    constexpr int CHUNKS = D / VEC;
    for (int i = tid; i < TILE_K * CHUNKS; i += NT) {
      const int j = i / CHUNKS, c = (i % CHUNKS) * VEC;
      const int p = k0 + j;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (p < limit) {
        const int64_t off = kv.row_offset(b, p, h, D) + c;
        kr = *reinterpret_cast<const uint4*>(kv.k + off);
        vr = *reinterpret_cast<const uint4*>(kv.v + off);
      }
      const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kr);
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[j * (D + 1) + c + e] = __bfloat162float(kh[e]);
        v_s[j * D + c + e] = __bfloat162float(vh[e]);
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * TILE_K; i += NT) {
      const int r = i / TILE_K, j = i % TILE_K;
      const int p = k0 + j;
      float s = kNegInf;
      if (p < limit) {
        const float* qr = q_s + r * D;
        const float* kj = k_s + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        s = dot;
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += NT / 32) {
      float* sr = s_s + r * TILE_K;
      float mx = kNegInf;
      for (int j = lane; j < TILE_K; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TILE_K; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int i = tid + a * NT;
      if (i < rows * D) {
        const int r = i / D, d = i % D;
        const float* pr = s_s + r * TILE_K;
        float o = acc[a] * a_s[r];
#pragma unroll 8
        for (int j = 0; j < TILE_K; ++j) o = fmaf(pr[j], v_s[j * D + d], o);
        acc[a] = o;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int i = tid + a * NT;
    if (i < rows * D) {
      out[row0 + i] = __float2bfloat16(acc[a] / fmaxf(l_s[i / D], 1e-30f));
    }
  }
}

// Launch one instantiation: raise the dynamic shared-memory cap once per
// device (the attribute is per device), then launch on the caller's stream.
// Returns cudaGetLastError().
template <int D, int TILE_K, int MAX_ROWS, int NT, class KV>
int launch_chunk_attention(const void* q, void* out, KV kv, const int* kv_len, int B, int Hkv,
                           int G, float sm_scale, cudaStream_t stream) {
  if (G < 1 || G > MAX_ROWS || B < 1 || Hkv < 1) return (int)cudaErrorInvalidValue;
  auto kernel = chunk_attention_kernel<D, TILE_K, MAX_ROWS, NT, KV>;
  constexpr size_t smem = sizeof(float) * chunk_smem_floats<D, TILE_K, MAX_ROWS>();
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
  kernel<<<dim3(1, Hkv, B), NT, smem, stream>>>(static_cast<const __nv_bfloat16*>(q),
                                                static_cast<__nv_bfloat16*>(out), kv, kv_len, G,
                                                sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace cct
