// Shared device body of the port's paged decode, paged prefill and
// contiguous decode kernels: a chunk of grouped (GQA) queries against K/V
// rows with an fp32 online softmax. (Contiguous prefill and flash run on the
// tensor-core body, tc_attention.cuh.)
//
// One CTA owns one (q-tile, kv head, batch row). Its query rows are
// `block_q` consecutive tokens x G grouped heads (row r = token r / G,
// group r % G), so every K/V byte a CTA stages serves all G heads of the
// group. The CTA walks the K/V rows it can see in TILE_K-row tiles:
//   1. stage the tile's K and V rows in shared memory as fp32 (16-byte
//      loads; rows at or past the visible limit are zero-filled);
//   2. scores S[r][j] = q_r . k_j, masked to -1e30 where the key is past
//      kv_len or after the query's absolute position write_index + t;
//   3. online softmax, one warp per row: m, l and the rescale factor live
//      in shared memory;
//   4. acc = acc * alpha + P V, each thread owning fixed (row, dim)
//      accumulators in registers.
// Tiles at or past min(kv_len, last causal position + 1) are never loaded,
// the same skip the TPU kernels make with pl.when.
//
// DECODE replays the TPU's contiguous decode kernel instead of the
// reference model's attention lines: one token per row (T = 1), no causal
// term (the token is the newest key, so kv_len is its only limit, and
// write_index is not read), and q * sm_scale kept in fp32 where the chunk
// path rounds it to bf16.
//
// The K/V addressing is a policy: PagedKV resolves logical row p through
// the block table (pool block table[b][p / bs], offset p % bs), so pool
// pages are read in place; ContiguousKV reads row p of a [B, S, Hkv, D]
// cache. Everything else is shared.
//
// Scores and P.V run on the CUDA cores in fp32 (two shared-memory reads per
// FMA). Moving paged prefill onto tc_attention.cuh (a paged TMA policy) and
// split-KV decode are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cct {

constexpr float kNegInf = -1e30f;

struct PagedKV {
  const __nv_bfloat16* k;  // this layer's pool [NB, bs, Hkv, D]
  const __nv_bfloat16* v;
  const int* tables;       // [B, nbl] pool block ids
  int nbl;
  int bs;
  int hkv;
  __device__ __forceinline__ int rows() const { return nbl * bs; }
  __device__ __forceinline__ int64_t row_offset(int b, int p, int h, int d) const {
    const int blk = tables[(int64_t)b * nbl + p / bs];
    return (((int64_t)blk * bs + p % bs) * hkv + h) * d;
  }
};

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

// q, out: [B, T, Hkv, G, D] bf16. Grid (ceil(T / block_q), Hkv, B), NT threads.
template <int D, int TILE_K, int MAX_ROWS, int NT, class KV, bool DECODE>
__global__ void __launch_bounds__(NT) chunk_attention_kernel(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, KV kv,
    const int* __restrict__ write_index, const int* __restrict__ kv_len, int T, int G,
    int block_q, float sm_scale) {
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
  const int t0 = blockIdx.x * block_q;
  const int n_t = min(block_q, T - t0);
  const int rows = n_t * G;  // <= MAX_ROWS (checked by the launcher)
  const int write = DECODE ? 0 : write_index[b];
  // keys this CTA can see: written (< kv_len), causal for its last query,
  // and inside the table / cache
  const int limit = DECODE ? min(kv_len[b], kv.rows())
                           : min(min(kv_len[b], write + t0 + n_t), kv.rows());

  // queries, scaled in the working dtype first (bf16) as the plain version,
  // or in fp32 as the TPU decode kernel
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = t0 + r / G, g = r % G;
    const int64_t off = ((((int64_t)b * T + t) * hkv + h) * G + g) * D + d;
    const float x = __bfloat162float(q[off]) * sm_scale;
    q_s[i] = DECODE ? x : __bfloat162float(__float2bfloat16(x));
  }
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
      if (p < limit && (DECODE || p <= write + t0 + r / G)) {
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
      const int r = i / D, d = i % D;
      const int t = t0 + r / G, g = r % G;
      const int64_t off = ((((int64_t)b * T + t) * hkv + h) * G + g) * D + d;
      out[off] = __float2bfloat16(acc[a] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// Launch one instantiation: raise the dynamic shared-memory cap once per
// device (the attribute is per device), then launch on the caller's stream.
// Returns cudaGetLastError().
template <int D, int TILE_K, int MAX_ROWS, int NT, bool DECODE = false, class KV>
int launch_chunk_attention(const void* q, void* out, KV kv, const int* write_index,
                           const int* kv_len, int B, int T, int Hkv, int G, float sm_scale,
                           cudaStream_t stream) {
  if (G < 1 || G > MAX_ROWS || T < 1 || B < 1 || Hkv < 1) return (int)cudaErrorInvalidValue;
  if (DECODE && T != 1) return (int)cudaErrorInvalidValue;
  auto kernel = chunk_attention_kernel<D, TILE_K, MAX_ROWS, NT, KV, DECODE>;
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
  const int block_q = MAX_ROWS / G;
  dim3 grid((T + block_q - 1) / block_q, Hkv, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const __nv_bfloat16*>(q),
                                     static_cast<__nv_bfloat16*>(out), kv, write_index, kv_len,
                                     T, G, block_q, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace cct
