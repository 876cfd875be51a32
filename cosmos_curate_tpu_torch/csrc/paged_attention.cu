// Paged GQA attention read through the block table (decode and chunked
// prefill), for sm_90a.
//
// Replaces cosmos_curate_tpu/ops/paged_attention.py:
//   - cct_paged_decode  <- _paged_decode / _paged_decode_kernel (T = 1)
//   - cct_paged_prefill <- _paged_prefill / _paged_prefill_kernel (T > 1)
// The TPU kernels put the block table in scalar prefetch and let the
// BlockSpec index map fetch pool block table[b, j] per grid step, carrying
// m / l / acc in VMEM scratch across the sequential grid. Hopper CTAs run in
// parallel and carry nothing between them, so here each CTA walks its own
// keys and reads pool pages in place through the table. The TPU's
// g_pad = max(8, G) sublane padding is not carried over.
//
// Paged prefill runs on the tensor-core body of tc_attention.cuh with the
// PagedPrefillCta policy: the geometry and precision of cct_prefill's
// PrefillCta (64 query rows of block_q tokens x gbox groups, one 5-d TMA box
// of q, heaviest query tiles first, bf16(q * sm_scale), P split hi + lo,
// 64-key tiles walked from key 0), so over the same K / V values the two
// kernels give bit-equal outputs. Only the K / V rows come from elsewhere:
// one tensor map over this layer's pool [NB, bs, Hkv, D] (dims D, Hkv, bs,
// NB).
//   - bs a multiple of 64: a key tile is one 64-row box inside its block;
//   - bs in {8, 16, 32}: a tile is 64 / bs boxes of bs rows, box i at row
//     i * bs of the panel. A box is whole 8-row swizzle atoms, so the layout
//     wgmma reads does not depend on how the hardware anchors the swizzle.
//     A box whose keys all lie at or past the CTA's last visible key names
//     block NB, out of range: TMA reads nothing, zero-fills it, and its
//     bytes still count toward the barrier's transaction total. Lane i of
//     the producer warp looks up box i's block one tile ahead, so lane 0
//     issues a tile's boxes without waiting on the table: with one lookup
//     per box in lane 0, four boxes a tile (bs = 16) ran at half the speed
//     of one (PERF.md);
//   - any other bs (below 8, or neither dividing nor a multiple of 64): the
//     producer warp copies the rows with 16-byte cp.async into the same
//     swizzled layout (kCopyKV), zero-filling rows past the visible keys.
// Keys past kv_len inside a loaded block are masked by the body's select,
// so whatever the pool holds there weighs exactly zero.
//
// Paged decode is split-KV on the CUDA cores (split_decode.cuh, PagedKV):
// grid (n_split, Hkv, B), the split count picked by the wrapper from the
// table width and the SM count, the partials merged by the last CTA of
// each (row, kv head) in the same launch.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): decode reads
// each visible K/V row once per (row, kv head), 2 * kv_len * D * 2 bytes,
// against 4 * G * kv_len * D flops, so it is bound by bytes. Prefill chunks
// of T = 64..256 tokens do ~G * T flops per K/V byte pair, near the bf16
// ridge; the tensor cores take the products.
#include "split_decode.cuh"
#include "tc_attention.cuh"

namespace {

constexpr int kMinBlocks = 2;  // cct_prefill's: the same register budget
constexpr int kRows = tca::kRows;
constexpr int kBK = tca::kBK;

struct PagedPrefillParams {
  __nv_bfloat16* out;          // [B, T, Hkv, G, D]
  const __nv_bfloat16* k_pool;  // this layer's [NB, bs, Hkv, D]
  const __nv_bfloat16* v_pool;
  const int* tables;  // [B, nbl]
  const int* write_index;
  const int* kv_len;
  int T, Hkv, G, nbl, bs, NB;
  int gbox, block_q, n_gt;  // groups and tokens per CTA, group tiles per kv head
  float q_scale;            // sm_scale, applied to q in bf16
};

template <int D, bool kCopy>
struct PagedPrefillCta {
  using Params = PagedPrefillParams;
  static constexpr bool kScaleQ = true;
  static constexpr bool kSplitP = true;
  static constexpr bool kWarpKV = true;
  static constexpr bool kCopyKV = kCopy;
  static constexpr int kMaxBoxes = kBK / 8;  // per key tile and tensor, at bs = 8
  const Params& p;
  int b, h, g0, t0, write, kvl, key_end, q_rows;

  __device__ explicit PagedPrefillCta(const Params& prm) : p(prm) {
    b = blockIdx.z;
    h = blockIdx.x / p.n_gt;
    g0 = (blockIdx.x % p.n_gt) * p.gbox;
    t0 = (gridDim.y - 1 - blockIdx.y) * p.block_q;  // heaviest query tiles first
    write = p.write_index[b];
    kvl = min(p.kv_len[b], p.nbl * p.bs);
    const int n_t = min(p.block_q, p.T - t0);
    key_end = max(0, min(kvl, write + t0 + n_t));
    q_rows = p.gbox * p.block_q;
  }
  __device__ float q_scale() const { return p.q_scale; }
  __device__ float score_scale() const { return tca::kLog2e; }

  __device__ int block(int key) const { return p.tables[(long long)b * p.nbl + key / p.bs]; }

  // q map dims (D, G, Hkv, T, B), box (W, gbox, 1, block_q, 1)
  __device__ void load_q(const CUtensorMap* map, uint32_t dst, uint32_t bar, int d0) const {
    tca::tma_load_5d(dst, map, bar, d0, g0, h, t0, b);
  }

  // Lane i's pool block for box i of key tile j: block NB (out of range,
  // zero-filled by TMA) where the box's keys all lie at or past key_end.
  __device__ int kv_lookup(int j, int lane) const {
    if constexpr (kCopy) return 0;  // cp.async rows look their blocks up themselves
    const int key = j * kBK + (p.bs >= kBK ? 0 : lane * p.bs);
    return lane < kBK / min(p.bs, kBK) && key < key_end ? block(key) : p.NB;
  }

  // Issue key tile key0 into the stage: TMA boxes from lane 0 over the pool
  // map (dims D, Hkv, bs, NB; box W, 1, min(bs, 64), 1), the blocks the
  // lanes looked up (`looked_up`) gathered by shuffles; or cp.async rows.
  __device__ void load_kv_tile(const CUtensorMap* mk, const CUtensorMap* mv, uint32_t k_tile, uint32_t k_bar,
                               uint32_t v_tile, uint32_t v_bar, int key0, int lane, int looked_up) const {
    using Pn = tca::Panels<D>;
    using L = tca::Smem<D>;
    if constexpr (kCopy) {
      const auto rows = [this, key0](const __nv_bfloat16* pool) {
        return [this, key0, pool](int r) -> const __nv_bfloat16* {
          const int key = key0 + r;
          if (key >= key_end) return nullptr;
          return pool + (((long long)block(key) * p.bs + key % p.bs) * p.Hkv + h) * D;
        };
      };
      tca::cp_async_tile<D>(k_tile, k_bar, lane, rows(p.k_pool), p.k_pool);
      tca::cp_async_tile<D>(v_tile, v_bar, lane, rows(p.v_pool), p.v_pool);
    } else {
      int blk[kMaxBoxes];
#pragma unroll
      for (int i = 0; i < kMaxBoxes; ++i) blk[i] = __shfl_sync(0xffffffffu, looked_up, i);
      if (lane != 0) return;
      const int box_rows = min(p.bs, kBK), boxes = kBK / box_rows;
      const int row0 = p.bs >= kBK ? key0 % p.bs : 0;
      const CUtensorMap* maps[2] = {mk, mv};
      const uint32_t tiles[2] = {k_tile, v_tile}, bars[2] = {k_bar, v_bar};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        tca::mbar_expect_tx(bars[x], L::kKVBytes);
#pragma unroll
        for (int pn = 0; pn < Pn::kCount; ++pn)
#pragma unroll
          for (int i = 0; i < kMaxBoxes; ++i)
            if (i < boxes)
              tca::tma_load_4d(tiles[x] + pn * L::kKVPanel + i * box_rows * Pn::kRowBytes, maps[x], bars[x],
                               pn * Pn::kW, h, row0, blk[i]);
      }
    }
  }
  __device__ tca::Row row(int r) const {
    const int t = t0 + r / p.gbox, g = g0 + r % p.gbox;
    const bool stored = r < q_rows && t < p.T && g < p.G;
    const long long off = ((((long long)b * p.T + t) * p.Hkv + h) * p.G + g) * D;
    return {min(kvl - 1, write + t), stored ? p.out + off : nullptr};
  }
};

// Whole TMA boxes serve bs when a box is 64 keys inside a block, or a
// whole number of 8-row swizzle atoms of which 64 / bs fill a tile.
bool tma_block_size(int bs) { return bs % kBK == 0 || (kBK % bs == 0 && bs >= 8); }

template <int D>
int paged_prefill_d(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                    const int* write_index, const int* kv_len, void* out, int B, int T, int Hkv, int G,
                    int nbl, int bs, int NB, float sm_scale, cudaStream_t stream) {
  using Pn = tca::Panels<D>;
  const int gbox = G < kRows ? G : kRows, block_q = kRows / gbox, n_gt = (G + gbox - 1) / gbox;
  const int n_qt = (T + block_q - 1) / block_q;
  if (n_qt > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const cuuint64_t e = 2;  // bytes per element
  const cuuint64_t qdim[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)Hkv, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t qstride[4] = {e * D, e * D * G, e * D * G * Hkv, e * D * G * Hkv * T};
  const cuuint32_t qbox[5] = {Pn::kW, (cuuint32_t)gbox, 1, (cuuint32_t)block_q, 1};
  CUtensorMap mq, mk, mv;
  int rc = tca::encode_map(&mq, q, 5, qdim, qstride, qbox, Pn::kRowBytes);
  if (rc != 0) return rc;
  const PagedPrefillParams p{static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(k_pool),
                             static_cast<const __nv_bfloat16*>(v_pool), tables, write_index, kv_len, T, Hkv,
                             G, nbl, bs, NB, gbox, block_q, n_gt, sm_scale};
  const dim3 grid((unsigned)(Hkv * n_gt), (unsigned)n_qt, (unsigned)B);
  if (!tma_block_size(bs)) return tca::launch<PagedPrefillCta<D, true>, D, kMinBlocks>(mq, mq, mq, p, grid, stream);
  const cuuint64_t kdim[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)bs, (cuuint64_t)NB};
  const cuuint64_t kstride[3] = {e * D, e * D * Hkv, e * D * Hkv * bs};
  const cuuint32_t kbox[4] = {Pn::kW, 1, (cuuint32_t)(bs < kBK ? bs : kBK), 1};
  rc = tca::encode_map(&mk, k_pool, 4, kdim, kstride, kbox, Pn::kRowBytes);
  if (rc == 0) rc = tca::encode_map(&mv, v_pool, 4, kdim, kstride, kbox, Pn::kRowBytes);
  if (rc != 0) return rc;
  return tca::launch<PagedPrefillCta<D, false>, D, kMinBlocks>(mq, mk, mv, p, grid, stream);
}

}  // namespace

extern "C" {

// q, out: [B, 1, Hkv, G, D] bf16; k_pool / v_pool: one layer's pool
// [NB, bs, Hkv, D] bf16; tables [B, nbl], kv_len [B] int32. With
// n_split > 1: part_ml [B * Hkv * n_split * G * 2] and part_acc
// [B * Hkv * n_split * G * D] fp32 scratch, counters [B * Hkv] int32 zeros
// (left zero); with one split they may be null.
int cct_paged_decode(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                     const int* kv_len, void* out, float* part_ml, float* part_acc, int* counters, int B,
                     int Hkv, int G, int D, int nbl, int bs, int n_split, float sm_scale, void* stream) {
  if (nbl < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  const sdk::PagedKV kv{static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
                        tables, nbl, bs};
  const sdk::SplitParams p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), kv_len,
                           part_ml, part_acc, counters, G, n_split, sm_scale};
  return sdk::dispatch_split_decode(D, kv, p, B, Hkv, static_cast<cudaStream_t>(stream));
}

// q, out: [B, T, Hkv, G, D] bf16; k_pool / v_pool: one layer's pool
// [NB, bs, Hkv, D] bf16; tables [B, nbl], write_index / kv_len [B] int32.
// Returns a cudaError_t, or 10000 + the CUresult of a tensor map libcuda
// refused.
int cct_paged_prefill(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                      const int* write_index, const int* kv_len, void* out, int B, int T, int Hkv, int G,
                      int D, int nbl, int bs, int NB, float sm_scale, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || G < 1 || nbl < 1 || bs < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return paged_prefill_d<16>(q, k_pool, v_pool, tables, write_index, kv_len, out, B, T, Hkv, G, nbl, bs, NB,
                                 sm_scale, st);
    case 64:
      return paged_prefill_d<64>(q, k_pool, v_pool, tables, write_index, kv_len, out, B, T, Hkv, G, nbl, bs, NB,
                                 sm_scale, st);
    case 128:
      return paged_prefill_d<128>(q, k_pool, v_pool, tables, write_index, kv_len, out, B, T, Hkv, G, nbl, bs, NB,
                                  sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
