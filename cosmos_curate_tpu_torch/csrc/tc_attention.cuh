// Tensor-core attention body for Hopper (sm_90a), shared by the flash
// (csrc/flash_attention.cu), contiguous-prefill (csrc/prefill_attention.cu)
// and paged-prefill (csrc/paged_attention.cu) kernels.
//
// A CTA owns 64 query rows of one (batch, head) and walks its visible keys
// in 64-key tiles. Its warps split into roles:
//   - one producer warp, whose lane 0 stages Q once and then K and V tile
//     by tile with TMA (cp.async.bulk.tensor) into a two-stage ring in
//     shared memory, each stage behind "full" mbarriers (the TMA's byte
//     count completes them) and an "empty" mbarrier (the consumers release
//     the stage), so loads run ahead of the math;
//   - one consumer warpgroup of 128 threads, which owns the 64 rows.
// A policy whose K / V rows are looked up per tile (kWarpKV: paged
// prefill's block table) runs the producer loop on the whole warp: each
// lane looks up one thing for the tile after the next (kv_lookup, a pool
// block id), so the lookups' round trip hides behind a tile's issue, and
// load_kv_tile issues the tile: TMA boxes from lane 0, or (kCopyKV) 16-byte
// cp.async from every lane into the same swizzled layout, each lane's
// copies completing one arrival on the stage's barrier (cp_async_tile).
// The geometry is fixed: on the H100 one warpgroup per CTA and several
// CTAs per SM (MIN_BLOCKS) beat two warpgroups sharing each K/V tile, and
// 64-key tiles beat 128 (PERF.md). Per key tile the warpgroup runs
//   1. S = Q K^T: wgmma m64n64k16, Q and K from shared memory (K-major), the
//      fp32 accumulators in registers;
//   2. the online softmax in the accumulator layout: a thread holds two rows
//      (r and r + 8), each spread over the four threads of a quad, so a row
//      max is two shuffles. Keys past the row's last visible key are set to
//      -1e30, keys are walked in order, and m starts at -1e30, so a row's
//      first visible key resets whatever fully masked tiles added, as in the
//      CUDA-core kernels before this body;
//   3. O = O * alpha + P V: wgmma m64nNk16 with P as the register A operand
//      (the S accumulators rounded to bf16 pairs, which is exactly the A
//      fragment layout) and V from shared memory in its row-major [key][d]
//      layout (the transposed-B form). P never goes through shared memory.
// The epilogue divides by max(l, 1e-30) and stores bf16 rows straight from
// registers; rows the policy marks as padding are never stored.
//
// Shared-memory tiles are what TMA writes with a swizzle: a [rows, D] bf16
// tile is D / W panels of rows x W elements (W = 64, 128-byte rows, 128-byte
// swizzle; at D = 16, W = 16 with the 32-byte swizzle), and the wgmma
// descriptors name the same swizzle. Ragged edges are TMA's zero fill plus
// the mask; key tiles past the CTA's last visible key are never loaded.
//
// What differs between the kernels is a policy (the `Cta` class): which
// query and K/V rows a CTA reads (its TMA coordinates), how far its keys
// run, each row's last visible key and where the row is stored, the scale
// on the fp32 scores, whether q is first rounded to bf16(q * sm_scale) in
// shared memory, and whether P enters P V as one bf16 part or as two
// (hi + lo, about fp32).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tca {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // query rows per CTA: one consumer warpgroup
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kNS = 2;        // K/V stages in the ring
constexpr int kThreads = 160;  // the consumer warpgroup and the producer warp

// Layout of a [rows, D] bf16 tile in shared memory, as TMA writes it.
template <int D>
struct Panels {
  static_assert(D == 16 || D % 64 == 0, "head dims 16 or multiples of 64");
  static constexpr int kW = D < 64 ? D : 64;  // elements per panel row
  static constexpr int kCount = D / kW;
  static constexpr int kRowBytes = 2 * kW;          // 32 or 128
  static constexpr int kAtomBytes = 8 * kRowBytes;  // one 8-row swizzle atom
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 3;
};

// Byte offsets of the shared-memory carve-up, from a 1024-byte aligned base.
template <int D>
struct Smem {
  static constexpr int kQPanel = kRows * Panels<D>::kRowBytes;
  static constexpr int kKVPanel = kBK * Panels<D>::kRowBytes;
  static constexpr int kKVBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kK = kRows * D * 2;
  static constexpr int kV = kK + kNS * kKVBytes;
  static constexpr int kBars = kV + kNS * kKVBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kNS);
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to realign the base
  static_assert(kK % 1024 == 0 && kKVBytes % 1024 == 0, "swizzle atoms stay 1024-byte aligned");
};

// ---- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// One arrival on the barrier once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Writes of the generic proxy (cp.async, st.shared) made visible to the
// async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulators across an async wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define CCT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CCT_F8(d, i) CCT_F4(d, i), CCT_F4(d, i + 4)
#define CCT_ACC8(d) CCT_F8(d, 0)
#define CCT_ACC32(d) CCT_F8(d, 0), CCT_F8(d, 8), CCT_F8(d, 16), CCT_F8(d, 24)

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CCT_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 16] (+)= A[64 x 16] . B[16 x 16], A in registers (bf16x2), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : CCT_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (bf16x2), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CCT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef CCT_ACC32
#undef CCT_ACC8
#undef CCT_F8
#undef CCT_F4

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 64, "value panels of 16 or 64");
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, b, 1);
  } else {
    wgmma_rs_n64(d, a, b, 1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One query row as the policy sees it: its last visible key (keys above it
// are masked) and where it is stored (nullptr: a padding row).
struct Row {
  int kmax;
  __nv_bfloat16* out;
};

// Copy one [kBK, D] bf16 key tile into the panels TMA would have written
// at `tile`: row r, 16-byte chunk c of a panel row lands where the
// hardware's swizzle puts it (chunk bits 4.. XOR address bits 7..; the
// panels are swizzle-atom aligned, so offsets stand for addresses). The
// warp's 32 lanes split the tile's chunks; row(r) gives key row r's global
// address or nullptr (zero-filled, nothing read; `any` is a valid address
// to name instead). Each lane then arrives once on `bar` when its copies
// have landed, so the barrier is initialised for 32 arrivals.
template <int D, class RowFn>
__device__ __forceinline__ void cp_async_tile(uint32_t tile, uint32_t bar, int lane, RowFn row,
                                              const __nv_bfloat16* any) {
  using Pn = Panels<D>;
  constexpr int kChunks = D / 8;                   // 16-byte chunks per key row
  constexpr int kPanelChunks = Pn::kRowBytes / 16;  // per panel row
  constexpr uint32_t kSwizzle = Pn::kRowBytes == 128 ? 7 : 1;
  for (int i = lane; i < kBK * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const __nv_bfloat16* src = row(r);
    const uint32_t lin = r * Pn::kRowBytes + (c % kPanelChunks) * 16;
    const uint32_t dst = tile + (c / kPanelChunks) * (kBK * Pn::kRowBytes) + (lin ^ (((lin >> 7) & kSwizzle) << 4));
    cp_async_16(dst, src != nullptr ? src + c * 8 : any, src != nullptr ? 16 : 0);
  }
  cp_async_arrive(bar);
}

// ---- the kernel
//
// Threads [0, 128) are the consumer warpgroup, warp 4 the producer.
// Cta(params) gives: key_end (keys the CTA walks, from 0), q_rows (rows
// Q's TMA box fills), load_q / load_kv (start the TMA of one panel) or,
// with kWarpKV, kv_lookup / load_kv_tile (the whole warp issues a K and a
// V tile; kCopyKV: by cp.async), row(r), kScaleQ / q_scale, kSplitP and
// the score scale (log2 domain).
template <class Cta, int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    tc_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ typename Cta::Params params) {
  using Pn = Panels<D>;
  using L = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kNS, empty = v_full + 8 * kNS;

  const Cta cta(params);
  const int n_tiles = (cta.key_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
      mbar_init(k_full + 8 * s, Cta::kCopyKV ? 32 : 1);  // lane arrivals, or one expect_tx
      mbar_init(v_full + 8 * s, Cta::kCopyKV ? 32 : 1);
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: Q once, then each K/V tile into the next free stage
    if (lane == 0) {
      mbar_expect_tx(q_full, cta.q_rows * D * 2);
#pragma unroll
      for (int p = 0; p < Pn::kCount; ++p) cta.load_q(&tm_q, q_s + p * L::kQPanel, q_full, p * Pn::kW);
    }
    if constexpr (Cta::kWarpKV) {
      int ahead = n_tiles > 0 ? cta.kv_lookup(0, lane) : 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kNS;
        const int now = ahead;
        if (j + 1 < n_tiles) ahead = cta.kv_lookup(j + 1, lane);  // in flight while tile j issues
        if (j >= kNS) mbar_wait(empty + 8 * s, ((j / kNS) - 1) & 1);
        cta.load_kv_tile(&tm_k, &tm_v, k_s + s * L::kKVBytes, k_full + 8 * s, v_s + s * L::kKVBytes,
                         v_full + 8 * s, j * kBK, lane, now);
      }
      if constexpr (Cta::kCopyKV) cp_async_wait_all();
    } else if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kNS;
        if (j >= kNS) mbar_wait(empty + 8 * s, ((j / kNS) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
#pragma unroll
        for (int p = 0; p < Pn::kCount; ++p)
          cta.load_kv(&tm_k, k_s + s * L::kKVBytes + p * L::kKVPanel, k_full + 8 * s, p * Pn::kW, j * kBK);
        mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
#pragma unroll
        for (int p = 0; p < Pn::kCount; ++p)
          cta.load_kv(&tm_v, v_s + s * L::kKVBytes + p * L::kKVPanel, v_full + 8 * s, p * Pn::kW, j * kBK);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows r and r + 8 of the CTA,
  // columns 8 n + cq (+1) of every n8 block
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const Row row0 = cta.row(r), row1 = cta.row(r + 8);

  mbar_wait(q_full, 0);
  if constexpr (Cta::kScaleQ) {
    // q * sm_scale rounded to bf16 before any product, as the plain version
    // does; elementwise, so the swizzle does not matter
    const float qs = cta.q_scale();
#pragma unroll
    for (int p = 0; p < Pn::kCount; ++p) {
      uint4* chunk = reinterpret_cast<uint4*>(smem_raw + (q_s + p * L::kQPanel - raw));
      for (int i = threadIdx.x; i < kRows * Pn::kRowBytes / 16; i += 128) {
        uint4 u = chunk[i];
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          h[e] = __floats2bfloat162_rn(f.x * qs, f.y * qs);
        }
        chunk[i] = u;
      }
    }
    fence_proxy_async();  // generic writes -> wgmma reads
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup only
  }
  __syncwarp();

  const float scale = cta.score_scale();
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[Pn::kCount][Pn::kW / 2];
#pragma unroll
  for (int p = 0; p < Pn::kCount; ++p)
#pragma unroll
    for (int i = 0; i < Pn::kW / 2; ++i) o[p][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kNS;
    const uint32_t parity = (j / kNS) & 1;
    const uint32_t k_tile = k_s + s * L::kKVBytes, v_tile = v_s + s * L::kKVBytes;

    // S = Q K^T over D in steps of 16 (32 bytes into a swizzled panel row)
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full + 8 * s, parity);
    if constexpr (Cta::kCopyKV) fence_proxy_async();
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk * 16 / Pn::kW, off = (kk * 16 % Pn::kW) * 2;
      wgmma_ss_n64(sc, smem_desc(q_s + p * L::kQPanel + off, 16, Pn::kAtomBytes, Pn::kLayout),
                   smem_desc(k_tile + p * L::kKVPanel + off, 16, Pn::kAtomBytes, Pn::kLayout), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);

    // mask, row max over the quad, rescale factors
    const int key0 = j * kBK + cq;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const int key = key0 + 8 * n;
      sc[4 * n] = key <= row0.kmax ? sc[4 * n] * scale : kNegInf;
      sc[4 * n + 1] = key + 1 <= row0.kmax ? sc[4 * n + 1] * scale : kNegInf;
      sc[4 * n + 2] = key <= row1.kmax ? sc[4 * n + 2] * scale : kNegInf;
      sc[4 * n + 3] = key + 1 <= row1.kmax ? sc[4 * n + 3] * scale : kNegInf;
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(s - m) in fp32 for l, rounded to bf16 pairs as wgmma's A fragments:
    // k-step kk's four registers are accumulators 8 kk .. 8 kk + 7 in order.
    // With kSplitP, P = hi + lo, two bf16 parts, which keeps P V at about
    // fp32 precision for one more wgmma per step.
    uint32_t pa[kBK / 16][4], pl[Cta::kSplitP ? kBK / 16 : 1][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 8 * kk + 2 * i;
        const float mrow = (i % 2 == 0) ? mn0 : mn1;  // registers 0, 2: row r; 1, 3: row r + 8
        const float p0 = exp2f(sc[e] - mrow), p1 = exp2f(sc[e + 1] - mrow);
        if (i % 2 == 0) {
          sum0 += p0 + p1;
        } else {
          sum1 += p0 + p1;
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        pa[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
        if constexpr (Cta::kSplitP) {
          const float2 back = __bfloat1622float2(hi);
          pl[kk][i] = pack_bf16(p0 - back.x, p1 - back.y);
        }
      }
    }
    l0 = l0 * alpha0 + sum0;  // a quad's partial sums: reduced once, at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int p = 0; p < Pn::kCount; ++p)
#pragma unroll
      for (int n = 0; n < Pn::kW / 8; ++n) {
        o[p][4 * n] *= alpha0;
        o[p][4 * n + 1] *= alpha0;
        o[p][4 * n + 2] *= alpha1;
        o[p][4 * n + 3] *= alpha1;
      }

    // O += P V, V [key][d] row-major: the MN-major B operand, 16 keys a step
    mbar_wait(v_full + 8 * s, parity);
    if constexpr (Cta::kCopyKV) fence_proxy_async();
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < Pn::kCount; ++p) {
        const uint64_t vd = smem_desc(v_tile + p * L::kKVPanel + kk * 16 * Pn::kRowBytes, L::kKVPanel,
                                      Pn::kAtomBytes, Pn::kLayout);
        wgmma_rs<Pn::kW>(o[p], pa[kk], vd);
        if constexpr (Cta::kSplitP) wgmma_rs<Pn::kW>(o[p], pl[kk], vd);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < Pn::kCount; ++p) reg_fence(o[p]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  const float den0 = fmaxf(quad_sum(l0), 1e-30f), den1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int p = 0; p < Pn::kCount; ++p)
#pragma unroll
    for (int n = 0; n < Pn::kW / 8; ++n) {
      const int col = p * Pn::kW + 8 * n + cq;
      if (row0.out != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(row0.out + col) =
            __floats2bfloat162_rn(o[p][4 * n] / den0, o[p][4 * n + 1] / den0);
      if (row1.out != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(row1.out + col) =
            __floats2bfloat162_rn(o[p][4 * n + 2] / den1, o[p][4 * n + 3] / den1);
    }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Returned for a tensor map libcuda refuses: kMapError + its CUresult.
constexpr int kMapError = 10000;

// A bf16 tensor map over `rank` dims, innermost first (dim 0 contiguous);
// strides in bytes for dims 1 .., box in elements. Out-of-bounds elements
// load as zeros. The swizzle is the one Panels<D> names for this row width.
inline int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box, int row_bytes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// Launch one instantiation on the caller's stream: raise the dynamic
// shared-memory cap once per device, then launch. Returns cudaGetLastError().
template <class Cta, int D, int MIN_BLOCKS>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const typename Cta::Params& params, dim3 grid, cudaStream_t stream) {
  auto kernel = tc_attention_kernel<Cta, D, MIN_BLOCKS>;
  constexpr int smem = Smem<D>::kLaunchBytes;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  static unsigned long long configured = 0;  // one bit per device
  if (!(configured & (1ull << device))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << device;
  }
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, params);
  return (int)cudaGetLastError();
}

}  // namespace tca
