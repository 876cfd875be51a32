// Split-KV (flash-decoding) GQA decode on the CUDA cores, for sm_90a: the
// body of both decode kernels, paged (cct_paged_decode,
// csrc/paged_attention.cu) and contiguous (cct_decode,
// csrc/decode_attention.cu).
//
// One new token per row attends to its visible keys. Decode is bound by
// bytes: each key brings 4 * D bytes of K and V for 4 * G * D flops, so
// tensor cores do not help; filling the card and keeping loads in flight
// do. So the keys of a (row, kv head) are cut into n_split ranges, one CTA
// each: grid (n_split, Hkv, B). A CTA's rows are the G grouped heads, so
// each K / V byte is read once for all of them.
//
// Inside a CTA, a key row is read by D / 8 neighbouring threads, 16 bytes
// each (8 threads at D = 64); the CTA's 128 threads are kThreads / (D / 8)
// key slots. Each pass a thread loads kKeysPerThread keys' K and V into
// registers, and the next pass's loads are issued before this pass's math,
// so two passes of a split (all 128 keys of a 1024-key table cut in 8) are
// in flight at once. Scores are the thread's 8-dim partial dot reduced
// over the key's threads with shuffles; each slot keeps its own fp32
// online softmax (m, l) and P V accumulators for its 8 dims of every
// grouped head. At the end of the split the slots merge in log-sum-exp
// form: shuffles inside a warp, then shared memory across the four warps.
//
// With one split the CTA writes the output. Otherwise it writes its
// partial (m, l, unnormalised acc) to a workspace, and the last CTA of the
// (row, kv head) to finish, found by an int32 counter, merges the partials
// (kMergeBatch at a time, all their loads in flight together) and sets the
// counter back to zero, so a decode stays one launch. A split
// that starts at or past the row's visible keys writes an empty partial
// (m = -1e30, l = 0), which the merge skips.
//
// Precision is the TPU decode kernels' (paged and contiguous alike): q *
// sm_scale in fp32, fp32 scores and P, fp32 P V, acc / max(l, 1e-30). Keys
// at or past min(kv_len, width) are never loaded and weigh exactly zero; a
// row with kv_len 0 gives zeros.
//
// The K / V addressing is a policy, and nothing else differs between the
// two kernels: PagedKV resolves logical key p through the block table
// (pool block tables[b][p / bs], row p % bs), so pool pages are read in
// place; ContiguousKV reads row p of a [B, S, Hkv, D] cache, one dependent
// load fewer per key. On the same K / V values, at a width of S = nbl * bs
// and the same split count, the two give the same bits: the same split
// boundaries, the same key for each thread, the same merge order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sdk {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// kKeysPerThread and kMergeBatch were chosen by scripts/tc_attention_ab.py's
// sweep at the caption engine's two lanes (PERF.md)
constexpr int kKeysPerThread = 4;  // keys a thread loads per pass
constexpr int kMaxGroup = 16;      // grouped heads a CTA holds
constexpr int kMergeBatch = 4;     // partials the merge loads at once

struct PagedKV {
  const __nv_bfloat16* k;  // this layer's pool [NB, bs, Hkv, D]
  const __nv_bfloat16* v;
  const int* tables;  // [B, nbl] pool block ids
  int nbl;
  int bs;
  __device__ __forceinline__ int rows() const { return nbl * bs; }
  __device__ __forceinline__ long long row_offset(int b, int p, int h, int hkv, int d) const {
    const int blk = tables[(long long)b * nbl + p / bs];
    return (((long long)blk * bs + p % bs) * hkv + h) * d;
  }
};

struct ContiguousKV {
  const __nv_bfloat16* k;  // [B, S, Hkv, D]
  const __nv_bfloat16* v;
  int s;
  __device__ __forceinline__ int rows() const { return s; }
  __device__ __forceinline__ long long row_offset(int b, int p, int h, int hkv, int d) const {
    return (((long long)b * s + p) * hkv + h) * d;
  }
};

struct SplitParams {
  const __nv_bfloat16* q;  // [B, Hkv, G, D]
  __nv_bfloat16* out;      // [B, Hkv, G, D]
  const int* kv_len;       // [B]
  float* part_ml;          // [B, Hkv, n_split, G, 2]: (m, l) of each split
  float* part_acc;         // [B, Hkv, n_split, G, D]: unnormalised P V
  int* counters;           // [B * Hkv], zero between calls
  int G;
  int n_split;
  float sm_scale;
};

__device__ __forceinline__ void fence_acq_rel_gpu() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

// Merge softmax state (m, l, acc) with another (mo, lo, acco): log-sum-exp.
// Two empty states (m = -1e30, l = 0) stay empty.
__device__ __forceinline__ void lse_merge(float& m, float& l, float (&acc)[8], float mo, float lo,
                                          const float (&acco)[8]) {
  const float mn = fmaxf(m, mo);
  const float a = expf(m - mn), b = expf(mo - mn);
  l = l * a + lo * b;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + acco[e] * b;
  m = mn;
}

// GMAX: the grouped heads the registers are sized for (G <= GMAX).
template <int D, int GMAX, class KV>
__global__ void __launch_bounds__(kThreads) split_decode_kernel(const KV kv, const SplitParams p) {
  static_assert(D % 8 == 0 && (D / 8) <= 32 && 32 % (D / 8) == 0, "a key row is one power-of-2 lane group");
  constexpr int TPK = D / 8;           // threads per key row, 16 bytes each
  constexpr int SLOTS = kThreads / TPK;  // keys a pass covers per kKeysPerThread
  constexpr int U = kKeysPerThread;
  __shared__ __align__(16) float q_s[GMAX * D];
  __shared__ float acc_s[kWarps][GMAX * D];
  __shared__ float ml_s[kWarps][GMAX][2];
  __shared__ int last_s;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hkv = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = tid / TPK, c = tid % TPK;  // key slot, 8-dim chunk of the row
  const int G = p.G;
  const long long bh = (long long)b * hkv + h;

  const int width = kv.rows();
  const int limit = min(p.kv_len[b], width);
  const int per = (width + p.n_split - 1) / p.n_split;
  const int k_begin = split * per;
  const int k_end = min(k_begin + per, limit);

  float m[GMAX], l[GMAX], acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // this thread's 16 bytes of key k0 + u * SLOTS + slot, zeros past k_end
  uint4 kr[U], vr[U], kn[U], vn[U];
  auto load = [&](int k0, uint4(&kd)[U], uint4(&vd)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = k0 + u * SLOTS + slot;
      kd[u] = vd[u] = make_uint4(0, 0, 0, 0);
      if (key < k_end) {
        const long long off = kv.row_offset(b, key, h, hkv, D) + c * 8;
        kd[u] = __ldg(reinterpret_cast<const uint4*>(kv.k + off));
        vd[u] = __ldg(reinterpret_cast<const uint4*>(kv.v + off));
      }
    }
  };
  load(k_begin, kr, vr);
  // q after the first pass's loads are issued: its round trip overlaps theirs
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = __bfloat162float(p.q[bh * G * D + i]) * p.sm_scale;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += SLOTS * U) {
    load(k0 + SLOTS * U, kn, vn);  // the next pass in flight behind this one's math
    float kf[U][8], vf[U][8];
    bool seen[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unpack8(kr[u], kf[u]);
      unpack8(vr[u], vf[u]);
      seen[u] = k0 + u * SLOTS + slot < k_end;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + c * 8);
        const float4 qb = *reinterpret_cast<const float4*>(q_s + g * D + c * 8 + 4);
        const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        float s[U];
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[u][e], dot);
#pragma unroll
          for (int o = TPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[u] = dot;
          if (seen[u]) mx = fmaxf(mx, dot);
        }
        const float mn = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - mn);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pu = seen[u] ? expf(s[u] - mn) : 0.f;
          sum += pu;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu, vf[u][e], acc[g][e]);
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mn;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the key slots of a warp (lanes TPK apart share a chunk c), then
  // the warps through shared memory
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
#pragma unroll
      for (int o = TPK; o < 32; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        float ao[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        lse_merge(m[g], l[g], acc[g], mo, lo, ao);
      }
      if (lane < TPK) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc_s[warp][g * D + c * 8 + e] = acc[g][e];
        if (lane == 0) {
          ml_s[warp][g][0] = m[g];
          ml_s[warp][g][1] = l[g];
        }
      }
    }
  }
  __syncthreads();

  const bool direct = p.n_split == 1;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, ml_s[w][g][0]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ml_s[w][g][0] - mm);
      ll += wt * ml_s[w][g][1];
      o += wt * acc_s[w][i];
    }
    if (direct) {
      p.out[bh * G * D + i] = __float2bfloat16(o / fmaxf(ll, 1e-30f));
    } else {
      const long long part = bh * p.n_split + split;
      p.part_acc[part * G * D + i] = o;
      if (i % D == 0) {
        p.part_ml[(part * G + g) * 2] = mm;
        p.part_ml[(part * G + g) * 2 + 1] = ll;
      }
    }
  }
  if (direct) return;

  // the last split of this (row, kv head) to finish merges them all
  // (the barrier hands every thread's partial to thread 0, whose fences are
  // cumulative: release before the count, acquire after the last one)
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel_gpu();
    last_s = atomicAdd(p.counters + bh, 1) == p.n_split - 1;
    if (last_s) fence_acq_rel_gpu();
  }
  __syncthreads();
  if (!last_s) return;
  const long long part0 = bh * p.n_split;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    // kMergeBatch splits' loads at a time, issued before any is used; an
    // empty split (l = 0) holds no acc and weighs nothing
    float mm = kNegInf, ll = 0.f, o = 0.f;
    for (int s0 = 0; s0 < p.n_split; s0 += kMergeBatch) {
      float ms[kMergeBatch], ls[kMergeBatch], as[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const long long part = part0 + min(s0 + u, p.n_split - 1);
        ms[u] = __ldcg(p.part_ml + (part * G + g) * 2);
        ls[u] = s0 + u < p.n_split ? __ldcg(p.part_ml + (part * G + g) * 2 + 1) : 0.f;
        as[u] = __ldcg(p.part_acc + part * G * D + i);
      }
      float mb = mm;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) mb = ls[u] > 0.f ? fmaxf(mb, ms[u]) : mb;
      const float a = expf(mm - mb);
      ll *= a;
      o *= a;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float wt = ls[u] > 0.f ? expf(ms[u] - mb) : 0.f;
        ll += wt * ls[u];
        o += ls[u] > 0.f ? wt * as[u] : 0.f;
      }
      mm = mb;
    }
    p.out[bh * G * D + i] = __float2bfloat16(o / fmaxf(ll, 1e-30f));
  }
  if (tid == 0) p.counters[bh] = 0;
}

// Launch on the caller's stream: grid (n_split, Hkv, B). Returns
// cudaGetLastError().
template <int D, class KV>
int launch_split_decode(const KV& kv, const SplitParams& p, int B, int Hkv, cudaStream_t stream) {
  if (p.G < 1 || p.G > kMaxGroup || B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || p.n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (p.n_split > 1 && (p.part_ml == nullptr || p.part_acc == nullptr || p.counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.n_split, (unsigned)Hkv, (unsigned)B);
  if (p.G <= 2) {
    split_decode_kernel<D, 2, KV><<<grid, kThreads, 0, stream>>>(kv, p);
  } else if (p.G <= 4) {
    split_decode_kernel<D, 4, KV><<<grid, kThreads, 0, stream>>>(kv, p);
  } else if (p.G <= 8) {
    split_decode_kernel<D, 8, KV><<<grid, kThreads, 0, stream>>>(kv, p);
  } else {
    split_decode_kernel<D, 16, KV><<<grid, kThreads, 0, stream>>>(kv, p);
  }
  return (int)cudaGetLastError();
}

// launch_split_decode at a head dim of 16, 64 or 128; any other is refused.
template <class KV>
int dispatch_split_decode(int D, const KV& kv, const SplitParams& p, int B, int Hkv, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_split_decode<16>(kv, p, B, Hkv, stream);
    case 64:
      return launch_split_decode<64>(kv, p, B, Hkv, stream);
    case 128:
      return launch_split_decode<128>(kv, p, B, Hkv, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sdk
