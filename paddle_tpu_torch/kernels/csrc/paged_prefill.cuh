// The ragged paged-attention PREFILL loop on the CUDA cores, shared by the
// float kernel (paged_prefill.cu) and the int8 kernel
// (paged_prefill_int8.cu) for every call the tensor-core loop
// (paged_prefill_mma.cuh) does not take: q in float32, over float32 or int8
// pools (the tensor cores would take f32 only as TF32, about three decimal
// digits), and q in bfloat16 with a head dim that is not a multiple of 16
// or is above 128 (up to 256).
//
// Replaces: paddle_tpu/kernels/pallas/prefill_attention.py::_prefill_kernel
// (entry `prefill_attention`), its float arm and its quant=True arm, for
// those calls. One chunk of C queries of ONE sequence, the chunk's first
// token at absolute position `start`, attends over that sequence's K/V pages
// (the chunk's own K/V already written to them) with an absolute-position
// causal mask: the query at position p sees keys 0..p. Scores and the online
// softmax are f32 throughout, every product an exact f32 FMA. Rows at or
// past `valid` are chunk padding and are written as 0. For int8 pools each
// value is widened and multiplied by its token slot's f32 scale BEFORE any
// product, as the Pallas quant arm does (`pool_value` rounds the same way).
//
// Bound on the H100: operations. The causal score and value products cost
// 4 * dh operations per visible (query, key) pair, over 67 TFLOP/s in f32:
// at GPT-2 small's 12 heads of 64, C=1024 from position 0 is 1.61 GFLOP,
// 0.0241 ms, against 0.0038 ms for its ~12.6 MB of bytes; a 50-row chunk at
// position 768 is 121.9 MFLOP, 0.00182 ms, against 0.00164 ms of bytes (f32
// pools) or 0.00052 ms (int8). The pages the live rows see are read once
// (2 * keys * dh * itemsize bytes, plus 2 * 4 scale bytes per key for int8
// pools, over 3.35 TB/s).
//
// Design against that bound:
// - Register-tiled products. A block owns a tile of 64 query rows of one
//   head (q in shared memory; 1/sqrt(dh) multiplies the f32 scores after
//   the product, as in the tensor-core loop) and walks key tiles of
//   BK keys (64, or 32 above dh 128). Its 256 threads form a 16 x 16 grid:
//   thread (ty, tx) holds the scores of rows ty + 16 i (4 rows) against
//   keys tx + 16 j (BK / 16 keys) and forms them with FFMAs from float4
//   reads of shared memory, 64 FMAs per 8 reads, as an SGEMM does. Every tile row is padded to a stride of 4 mod 8 floats, so the 8
//   key rows a quarter warp reads fall in distinct banks. The row max takes
//   4 shuffles across the 16 threads of a row once per TILE, never per
//   key; the row sum stays a per-thread share, added across the 16 once at
//   the end. P goes to shared memory, and O += P V is tiled the same way:
//   each thread owns its 4 rows x 4 * DC columns. The causal mask costs
//   work only on tiles that cross a live row's limit.
// - Asynchronous page gather. Each key row of a head is dh contiguous
//   values, gathered page by page (page_table[key / page_size]) with
//   cp.async of 16 bytes (8 or 4 where the row or the pools are not so
//   aligned; plain loads for 1- or 2-byte rows) into a ring of 2 stages
//   (f32 pools: the stage is the f32 tile the products read) or 3 (int8 and
//   bf16 pools: the raw bytes and, for int8, the tile's K and V scales,
//   widened and scaled into one f32 tile once a tile, before the
//   products). The next tile's copies are in flight while this one is
//   multiplied. Keys past the tile's end are never read (source size 0
//   fills zeros, which the mask hides).
// - Key splits merged in the same launch (flash decoding), so that short
//   chunks deep in a slot fill the card. The grid is (query tiles, heads,
//   splits), taken in the order splits, heads, then query tiles from the
//   heaviest, so the first wave holds the longest chains. The split count
//   comes from shapes only (the wrapper's `core_splits`: C, nh,
//   pages_per_slot, page_size and the SM count), never from `start` /
//   `valid`, which lie on the card. The
//   slot's pages form units of max(1, BK / page_size) pages, and split s
//   walks units s, s + splits, s + 2 splits, ... up to the tile's causal
//   limit: units are interleaved, not ranges, so whatever the chunk's
//   position every split of a deep tile gets work. A split with no unit
//   before the limit reads no K or V and writes nothing (the merge knows
//   from the same shapes that it is empty), and still takes its ticket.
//   Each split's (acc, m, l) for its 64 rows goes to a workspace; the last
//   block of a (query tile, head) to finish (a __threadfence, then
//   atomicInc on its ticket, which wraps back to 0 and so is ready for the
//   next launch) merges the partials in split-index order, so results are
//   bit-identical from run to run and between a graph and eager calls.
//   With one split, or when the tile's visible keys all lie in split 0's
//   first unit, that block writes out directly. The wrapper allocates
//   the partials with torch.empty and shares the split decode loop's
//   tickets (zeroed once per device, row count and stream).
// - The page loop stops where the rows' causal limit says: a tile of
//   padding rows visits 0 pages; any other, across its splits,
//   ceil((start + last live row + 1) / page_size) pages (at most
//   pages_per_slot), each once. `visits` [query tiles, nh, splits] holds
//   each split's count.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"
#include "flash_common.cuh"
#include "mma_common.cuh"

namespace paddle_tpu_torch {
namespace prefill_core {

constexpr int kThreads = 256;       // a 16 x 16 grid of threads
constexpr int kBlockQ = 64;         // query rows of a block
constexpr int kRows = kBlockQ / 16;   // rows of a thread: ty + 16 i
constexpr int kMaxSplits = 32;      // the wrapper's CORE_MAX_SPLITS
// dynamic shared memory a block may take: the H100's 227 KB opt-in limit
// less room for the kernel's static arrays
constexpr int kMaxSmem = 232448 - 1024;

// keys of a tile: 64 (4 a thread) up to dh 128, 32 (2 a thread) above, so
// that the widest rows still fit two stages (the wrapper's `core_keys`)
inline int tile_keys(int dh) { return dh <= 128 ? 64 : 32; }

// Shared-memory layout of one block, in bytes. f32 tile rows are padded
// to `ld` floats (dh rounded up to 8, plus 4: a stride of 4 mod 8 floats),
// P rows to BK + 16 floats (the two row groups of a warp write 16 banks
// apart). A ring stage holds a tile's K rows, then its V rows, `rs` bytes
// apart (f32 pools: the f32 tile itself), then for int8 pools its BK K and
// BK V scales; narrow pools are widened into one f32 K/V tile (`wide`).
struct CoreLayout {
  int ld, ldp, rs, stages, stage_bytes, q_off, p_off, wide_off, ring_off,
      bytes;
};

inline CoreLayout core_layout(int dh, int item, int bk, bool int8,
                              bool f32_pool) {
  CoreLayout L;
  L.ld = (dh + 7) / 8 * 8 + 4;
  L.ldp = bk + 16;
  L.rs = f32_pool ? 4 * L.ld : (dh * item + 15) / 16 * 16;
  L.stage_bytes = 2 * bk * L.rs + (int8 ? 2 * bk * 4 : 0);
  const int q = kBlockQ * L.ld * 4, p = kBlockQ * L.ldp * 4;
  const int wide = f32_pool ? 0 : 2 * bk * L.ld * 4;
  L.stages = !f32_pool && q + p + wide + 3 * L.stage_bytes <= kMaxSmem ? 3 : 2;
  L.q_off = 0;
  L.p_off = q;
  L.wide_off = q + p;
  L.ring_off = q + p + wide;
  L.bytes = L.ring_off + L.stages * L.stage_bytes;
  return L;
}

// The widest copy that divides a pool row and both pools' alignment: 16, 8
// or 4 bytes by cp.async, else the element size by plain loads.
inline int copy_granule(int row_bytes, int item, const void* k,
                        const void* v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | (uintptr_t)row_bytes;
  for (int g = 16; g >= 4; g >>= 1)
    if ((a & (uintptr_t)(g - 1)) == 0) return g;
  return item;
}

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// `gran` bytes of a pool row into shared memory; zeros when !live (the
// source is then not read).
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src, int gran,
                                           bool live) {
  const unsigned d = smem_addr(dst);
  if (gran == 16) {
    cp_async16(d, src, live);
  } else if (gran == 8) {
    cp_async8(d, src, live);
  } else if (gran == 4) {
    cp_async4(d, src, live);
  } else if (gran == 2) {
    *reinterpret_cast<unsigned short*>(dst) =
        live ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
  } else {
    *dst = live ? __ldg(src) : 0;
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(signed char x) { return (float)x; }

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// T: q and out (float or bf16); P: pools (T, or int8 with scales). DC: the
// float4 column chunks of O a thread owns (tx + 16 c), so dh <= 64 * DC;
// KPT: keys of a tile a thread owns (tx + 16 j), BK = 16 * KPT.
template <typename T, typename P, int DC, int KPT>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 2 : 1)
paged_prefill_core_kernel(const T* __restrict__ q,
                          const P* __restrict__ k_pages,
                          const P* __restrict__ v_pages,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ page_table,
                          T* __restrict__ out, int* __restrict__ visits,
                          float* __restrict__ partials,
                          unsigned* __restrict__ tickets, int c, int nh,
                          int dh, int ps, int ps_shift, int maxp,
                          const int* __restrict__ start_p,
                          const int* __restrict__ valid_p, int block_q,
                          int ppt, int gran, bool q_vec, CoreLayout lay,
                          float scale) {
  constexpr int BK = 16 * KPT;
  constexpr bool kF32Pool = std::is_same_v<P, float>;
  constexpr bool kInt8 = std::is_same_v<P, signed char>;
  extern __shared__ __align__(16) unsigned char core_smem[];
  float* qs = reinterpret_cast<float*>(core_smem + lay.q_off);
  float* pt = reinterpret_cast<float*>(core_smem + lay.p_off);
  float* wide = reinterpret_cast<float*>(core_smem + lay.wide_off);
  unsigned char* ring = core_smem + lay.ring_off;
  __shared__ float sm_inv[kBlockQ];
  __shared__ bool sm_last;

  // blocks in launch order: the splits of one (tile, head), then the
  // heads, then the query tiles from the last (the heaviest) back, so the
  // first wave holds the longest chains
  const int splits = gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                                         blockIdx.z);
  const int split = lin % splits, h = (lin / splits) % nh;
  const int qt = gridDim.x - 1 - lin / (splits * nh);
  const int tid = threadIdx.x;
  // key row of a tile this thread copies (kTpr threads a row)
  constexpr int kTpr = kThreads / BK;
  const int t = tid / kTpr, sub = tid % kTpr;
  // the page of its key in the split's first tile, read before `start`
  // and `valid` are known (the index is the shape's; clamped to the row)
  const int first_page = __ldg(
      page_table + min((split * ppt * ps + t) / ps, maxp - 1));
  const ChunkBounds cb = load_chunk_bounds(start_p, valid_p, c, maxp * ps);
  const int start = cb.start, valid = cb.valid;
  // the 16 threads of a row (one ty) are a half-warp (flash_common.cuh)
  const int tx = flash::tile_tx(), ty = flash::tile_ty();
  const int row0 = qt * block_q;
  const int nrows = max(0, min(valid - row0, block_q));   // live rows
  const int rows_out = min(block_q, c - row0);            // rows of `out`
  // keys [0, kv_end): up to the last live row's position, in the slot
  const int kv_end = nrows > 0 ? min(start + row0 + nrows, maxp * ps) : 0;
  const int npages = (kv_end + ps - 1) / ps;
  const int ukeys = ppt * ps;                     // keys of a unit
  const int nunits = (npages + ppt - 1) / ppt;    // units before the limit
  const int tpu = (ukeys + BK - 1) / BK;          // tiles of a unit
  // this split's units: split, split + splits, ... < nunits
  const int my_units =
      nunits > split ? (nunits - 1 - split) / splits + 1 : 0;
  const int ntiles = my_units * tpu;
  const int bh = qt * nh + h;
  const size_t tok = (size_t)nh * dh;
  const int dh4 = (dh + 3) & ~3, n4 = dh4 / 4;
  if (visits != nullptr && tid == 0) {
    int pages = my_units * ppt;   // the last unit may be cut at npages
    if (my_units > 0 && (nunits - 1) % splits == split)
      pages -= nunits * ppt - npages;
    visits[(size_t)bh * splits + split] = pages;
  }

  if (nrows == 0) {   // a tile of padding rows: split 0 writes its zeros
    if (split == 0)
      for (int e = tid; e < rows_out * dh; e += kThreads)
        out[(size_t)(row0 + e / dh) * tok + (size_t)h * dh + e % dh] =
            from_float<T>(0.f);
    return;
  }
  // every visible key in split 0's one unit (a short chunk near the slot's
  // start): split 0 writes out as a lone split would, the others leave at
  // once and no block takes the ticket
  const bool alone = splits == 1 || nunits == 1;
  if (alone && split > 0) return;

  float acc[kRows][DC][4], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][cc][e] = 0.f;
  }

  // key span [k0, kend) of the split's tile i
  auto tile_span = [&](int i, int& k0, int& kend) {
    const int unit = split + (i / tpu) * splits;
    k0 = unit * ukeys + (i % tpu) * BK;
    kend = min(min(k0 + BK, (unit + 1) * ukeys), kv_end);
  };

  if (ntiles > 0) {   // block-uniform
    const int ld = lay.ld, ldp = lay.ldp, rs = lay.rs, nst = lay.stages;
    // copy mapping: key row t of a tile, chunks sub, sub + kTpr, ... of
    // its `cpr` chunks of `gran` bytes (K and V); for int8 pools sub 0
    // copies the row's K scale and sub 1 its V scale. One page-table entry
    // a thread a tile, looked up a tile ahead.
    const int cpr = dh * (int)sizeof(P) / gran;
    // the page of this thread's key in the split's tile i; -1 past the end
    auto page_of = [&](int i) {
      if (i >= ntiles) return -1;
      int k0, kend;
      tile_span(i, k0, kend);
      const int key = k0 + t;
      if (key >= kend) return -1;
      if (i == 0) return first_page;
      return __ldg(page_table + (ps_shift >= 0 ? key >> ps_shift : key / ps));
    };
    auto issue = [&](int i, int page) {
      if (i < ntiles) {
        unsigned char* st = ring + (size_t)(i % nst) * lay.stage_bytes;
        int k0, kend;
        tile_span(i, k0, kend);
        const int key = k0 + t;
        const bool live = page >= 0;
        // token slot of the key, and its row's element offset in a pool
        const size_t slot =
            live ? (size_t)page * ps + (ps_shift >= 0 ? key & (ps - 1)
                                                      : key % ps)
                 : 0;
        const size_t row = slot * tok + (size_t)h * dh;
        const unsigned char* kb =
            reinterpret_cast<const unsigned char*>(k_pages + row);
        const unsigned char* vb =
            reinterpret_cast<const unsigned char*>(v_pages + row);
        for (int ch = sub; ch < cpr; ch += kTpr) {
          const int off = ch * gran;
          copy_chunk(st + (size_t)t * rs + off, kb + off, gran, live);
          copy_chunk(st + (size_t)(BK + t) * rs + off, vb + off, gran, live);
        }
        if constexpr (kInt8) {   // the tile's K scales, then its V scales
          if (sub < 2) {
            const float* src = (sub == 0 ? k_scale : v_scale) + slot * nh + h;
            cp_async4(smem_addr(st + 2 * BK * rs + 4 * (sub * BK + t)), src,
                      live);
          }
        }
      }
      cp_async_commit();   // one group a tile, empty past the last
    };
    // the stage's raw K and V rows widened (and scaled) into `wide`
    auto widen_tile = [&](const unsigned char* st) {
      const float* scl = reinterpret_cast<const float*>(st + 2 * BK * rs);
      for (int e = tid; e < 2 * BK * n4; e += kThreads) {
        const int r = e / n4, c4 = e - r * n4;
        const P* src = reinterpret_cast<const P*>(st + (size_t)r * rs);
        const float sc = kInt8 ? scl[r] : 1.f;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = 4 * c4 + j;
          v[j] = 0.f;
          if (d < dh) {
            if constexpr (kInt8)
              v[j] = widen(src[d]) * sc;
            else
              v[j] = widen(src[d]);
          }
        }
        *reinterpret_cast<float4*>(wide + (size_t)r * ld + 4 * c4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    };

    if constexpr (kF32Pool) {
      // the ring's columns past dh that the products read: never copied
      const int pad = dh4 - dh;
      for (int e = tid; e < nst * 2 * BK * pad; e += kThreads) {
        const int r = e / pad;
        reinterpret_cast<float*>(ring)[(size_t)r * ld + dh + e - r * pad] =
            0.f;
      }
    }
    // the Q tile (unscaled: the scale multiplies S), zeros for padding
    // rows: f32 rows of 16-byte chunks by cp.async in tile 0's copy group,
    // so that it loads beside tile 0's keys; else, once tile 0's copies
    // are in flight, eight loads a thread before any is stored, and zeros
    // past dh
    const T* qb = q + (size_t)row0 * tok + (size_t)h * dh;
    if (q_vec) {
      const int qc = dh / 4;   // 16-byte chunks of a row
      for (int e = tid; e < kBlockQ * qc; e += kThreads) {
        const int r = e / qc, ch = e - r * qc;
        cp_async16(smem_addr(qs + (size_t)r * ld + 4 * ch),
                   qb + (r < nrows ? (size_t)r * tok + 4 * ch : 0),
                   r < nrows);
      }
    }
    for (int i = 0; i < nst - 1; ++i) issue(i, page_of(i));
    int next_page = page_of(nst - 1);   // in flight while tile 0 loads
    if (!q_vec) {
      constexpr int kBatch = 8;
      for (int e0 = 0; e0 < kBlockQ * ld; e0 += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads + tid;
          const int r = e / ld, d = e - r * ld;
          v[u] = r < nrows && d < dh ? to_float(qb[(size_t)r * tok + d])
                                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads + tid;
          if (e < kBlockQ * ld) qs[e] = v[u];
        }
      }
    }

    for (int i = 0; i < ntiles; ++i) {
      if (nst == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();   // tile i is in; tile i - 1 is no longer read
      issue(i + nst - 1, next_page);
      next_page = page_of(i + nst);   // used next tile: its load overlaps
      const unsigned char* st = ring + (size_t)(i % nst) * lay.stage_bytes;
      const float* kt;
      if constexpr (kF32Pool) {
        kt = reinterpret_cast<const float*>(st);
      } else {
        widen_tile(st);
        __syncthreads();
        kt = wide;
      }
      const float* vt = kt + (size_t)BK * ld;
      int k0, kend;
      tile_span(i, k0, kend);

      // S = (q K^T) * scale: rows ty + 16 i, keys tx + 16 j
      float s[kRows][KPT];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[r][j] = 0.f;
      const float* qr = qs + (size_t)ty * ld;
      const float* kr = kt + (size_t)tx * ld;
#pragma unroll 2
      for (int d = 0; d < dh4; d += 4) {
        float4 a[kRows], b[KPT];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          a[r] = *reinterpret_cast<const float4*>(qr + (size_t)16 * r * ld + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          b[j] = *reinterpret_cast<const float4*>(kr + (size_t)16 * j * ld + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            s[r][j] = fmaf(a[r].x, b[j].x, s[r][j]);
            s[r][j] = fmaf(a[r].y, b[j].y, s[r][j]);
            s[r][j] = fmaf(a[r].z, b[j].z, s[r][j]);
            s[r][j] = fmaf(a[r].w, b[j].w, s[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[r][j] *= scale;
      // the mask, only on a tile some live row cannot see whole: key k is
      // visible to the row at p when k <= p and k < kend
      if (k0 + BK > min(start + row0 + 1, kend)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int lim = min(start + row0 + ty + 16 * r + 1, kend);
#pragma unroll
          for (int j = 0; j < KPT; ++j)
            if (k0 + tx + 16 * j >= lim) s[r][j] = -INFINITY;
        }
      }
      // online softmax: one row max a tile (4 shuffles), P to shared memory
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float mx = s[r][0];
#pragma unroll
        for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[r][j]);
        const float mn = fmaxf(m[r], flash::half_warp_max(mx));
        const float mu = mn == -INFINITY ? 0.f : mn;   // a row seeing nothing
        const float alpha = expf(m[r] - mu);
        float ls = 0.f;
        float* prow = pt + (size_t)(ty + 16 * r) * ldp + tx;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const float p = expf(s[r][j] - mu);   // 0 where masked
          ls += p;
          prow[16 * j] = p;
        }
        l[r] = l[r] * alpha + ls;
        m[r] = mn;
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][cc][e] *= alpha;
      }
      __syncthreads();
      // O += P V: rows ty + 16 i, columns 4 (tx + 16 c) .. + 3
      const float* pr = pt + (size_t)ty * ldp;
#pragma unroll 2
      for (int k = 0; k < BK; k += 4) {
        float4 pp[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          pp[r] = *reinterpret_cast<const float4*>(pr + (size_t)16 * r * ldp + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vr = vt + (size_t)(k + kk) * ld;
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            const int ch = tx + 16 * cc;
            if (ch < n4) {   // no column of the row past dh4
              const float4 v = *reinterpret_cast<const float4*>(vr + 4 * ch);
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const float p = comp(pp[r], kk);
                acc[r][cc][0] = fmaf(p, v.x, acc[r][cc][0]);
                acc[r][cc][1] = fmaf(p, v.y, acc[r][cc][1]);
                acc[r][cc][2] = fmaf(p, v.z, acc[r][cc][2]);
                acc[r][cc][3] = fmaf(p, v.w, acc[r][cc][3]);
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();   // nothing left in flight past the last tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) l[r] = flash::half_warp_sum(l[r]);

  if (alone) {   // the block holds the whole row: write out
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 16 * r;
      if (row >= rows_out) continue;
      const float inv = row < nrows ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
      T* orow = out + (size_t)(row0 + row) * tok + (size_t)h * dh;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int ch = tx + 16 * cc;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * ch + e;
          if (d < dh) orow[d] = from_float<T>(acc[r][cc][e] * inv);
        }
      }
    }
    return;
  }

  // partials [query tiles * nh][splits]: acc [64][dh4], then m [64], l [64]
  const size_t pstride = (size_t)kBlockQ * (dh4 + 2);
  if (ntiles > 0) {   // an empty split writes nothing: the merge skips it
    float* part = partials + ((size_t)bh * splits + split) * pstride;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int ch = tx + 16 * cc;
        if (ch < n4)
          *reinterpret_cast<float4*>(part + (size_t)row * dh4 + 4 * ch) =
              make_float4(acc[r][cc][0], acc[r][cc][1], acc[r][cc][2],
                          acc[r][cc][3]);
      }
      if (tx == 0) {
        part[(size_t)kBlockQ * dh4 + row] = m[r];
        part[(size_t)kBlockQ * dh4 + kBlockQ + row] = l[r];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sm_last = atomicInc(tickets + bh, (unsigned)(splits - 1)) ==
              (unsigned)(splits - 1);
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // the last block of (query tile, head): merge the partials of the
  // splits that walked a unit (0 .. nsp - 1: units are dealt in split
  // order), in split order, read from L2. Their m and l go to shared
  // memory first, loaded eight at a time; then the weights [nsp][64].
  const float* pb = partials + (size_t)bh * splits * pstride;
  const int nsp = min(splits, nunits);
  float* sm_ml = reinterpret_cast<float*>(core_smem);   // [nsp][2][64]
  constexpr int kBatch = 8;
  for (int e0 = 0; e0 < nsp * 2 * kBlockQ; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + tid;
      const int sp = e / (2 * kBlockQ);
      v[u] = e < nsp * 2 * kBlockQ
                 ? __ldcg(pb + sp * pstride + (size_t)kBlockQ * dh4 +
                          (e - sp * 2 * kBlockQ))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + tid;
      if (e < nsp * 2 * kBlockQ) sm_ml[e] = v[u];
    }
  }
  __syncthreads();
  if (tid < kBlockQ) {   // row tid: max, weights, 1 / sum
    const int row = tid;
    float mx = -INFINITY;
    for (int sp = 0; sp < nsp; ++sp)
      mx = fmaxf(mx, sm_ml[sp * 2 * kBlockQ + row]);   // finite: split 0
    float lsum = 0.f;
    for (int sp = 0; sp < nsp; ++sp) {
      const float ms = sm_ml[sp * 2 * kBlockQ + row];
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      sm_ml[sp * 2 * kBlockQ + row] = w;
      lsum += w * sm_ml[sp * 2 * kBlockQ + kBlockQ + row];
    }
    sm_inv[row] = row < nrows ? 1.f / fmaxf(lsum, 1e-30f) : 0.f;
  }
  __syncthreads();
  // each thread's outputs (up to 4 * DC float4), 4 / DC splits at a time:
  // 16 loads in flight, added in split order
  constexpr int kEpt = 4 * DC, kSb = 4 / DC;
  const int nel = rows_out * n4;
  float4 acc4[kEpt];
  int erow[kEpt];
  const float* src[kEpt];
#pragma unroll
  for (int u = 0; u < kEpt; ++u) {
    const int e = tid + u * kThreads;
    const int row = e < nel ? e / n4 : kBlockQ;
    erow[u] = row;
    src[u] = pb + (row < kBlockQ ? (size_t)row * dh4 + 4 * (e - row * n4)
                                 : 0);
    acc4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s0 = 0; s0 < nsp; s0 += kSb) {
    float4 v[kEpt][kSb];
#pragma unroll
    for (int u = 0; u < kEpt; ++u)
#pragma unroll
      for (int b = 0; b < kSb; ++b)
        if (erow[u] < nrows && s0 + b < nsp)
          v[u][b] = __ldcg(
              reinterpret_cast<const float4*>(src[u] + (s0 + b) * pstride));
#pragma unroll
    for (int u = 0; u < kEpt; ++u)
#pragma unroll
      for (int b = 0; b < kSb; ++b)
        if (erow[u] < nrows && s0 + b < nsp) {
          const float w = sm_ml[(s0 + b) * 2 * kBlockQ + erow[u]];
          acc4[u].x += w * v[u][b].x;
          acc4[u].y += w * v[u][b].y;
          acc4[u].z += w * v[u][b].z;
          acc4[u].w += w * v[u][b].w;
        }
  }
#pragma unroll
  for (int u = 0; u < kEpt; ++u) {
    const int e = tid + u * kThreads;
    if (e >= nel) continue;
    const int row = erow[u], ch = e - row * n4;
    const float inv = sm_inv[row];
    T* orow = out + (size_t)(row0 + row) * tok + (size_t)h * dh;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * ch + j;
      if (d < dh) orow[d] = from_float<T>(comp(acc4[u], j) * inv);
    }
  }
}

}  // namespace prefill_core

// Launches the CUDA-core prefill loop on `stream` for q/out of type T over
// pools of element type P (T, or signed char with its f32 k_scale /
// v_scale). `visits` ([ceil(c / block_q), nh, splits] int32) may be null;
// `partials` ([ceil(c / block_q) * nh * splits * 64 * (dh4 + 2)] f32, dh4 =
// dh rounded up to 4) and `tickets` ([ceil(c / block_q) * nh] u32, zero
// before the first launch and left zero by every launch) may be null only
// for splits == 1. Returns the launch's cudaGetLastError() (or the error of
// raising the block's dynamic shared-memory limit).
template <typename T, typename P>
int launch_paged_prefill(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const int* page_table,
                         void* out, int* visits, float* partials,
                         unsigned* tickets, int c, int nh, int dh, int ps,
                         int maxp, const int* start, const int* valid,
                         int block_q, int splits, cudaStream_t stream) {
  using namespace prefill_core;
  constexpr bool kInt8 = std::is_same_v<P, signed char>;
  constexpr bool kF32Pool = std::is_same_v<P, float>;
  if (splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (partials == nullptr || tickets == nullptr)) ||
      (kInt8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int bk = tile_keys(dh);
  const CoreLayout lay =
      core_layout(dh, (int)sizeof(P), bk, kInt8, kF32Pool);
  if (lay.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int ppt = ps < bk ? bk / ps : 1;   // pages of a split unit
  const int gran =
      copy_granule(dh * (int)sizeof(P), (int)sizeof(P), k_pages, v_pages);
  // f32 q rows copied 16 bytes at a time
  const bool q_vec = std::is_same_v<T, float> && dh % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int ps_shift = -1;
  if ((ps & (ps - 1)) == 0)
    for (ps_shift = 0; (1 << ps_shift) < ps; ++ps_shift) {
    }
  const dim3 grid((c + block_q - 1) / block_q, nh, splits);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pages);
  const P* vp = static_cast<const P*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  T* op = static_cast<T*>(out);
#define PTT_PREFILL(DC, KPT)                                                 \
  do {                                                                       \
    auto kern = paged_prefill_core_kernel<T, P, DC, KPT>;                    \
    if (lay.bytes > 48 * 1024) {                                             \
      cudaError_t err = cudaFuncSetAttribute(                                \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);     \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    kern<<<grid, kThreads, lay.bytes, stream>>>(                             \
        qp, kp, vp, ks, vs, page_table, op, visits, partials, tickets, c,    \
        nh, dh, ps, ps_shift, maxp, start, valid, block_q, ppt, gran, q_vec, \
        lay, scale);                                                         \
  } while (0)
  if (dh <= 64) PTT_PREFILL(1, 4);
  else if (dh <= 128) PTT_PREFILL(2, 4);
  else PTT_PREFILL(4, 2);
#undef PTT_PREFILL
  return (int)cudaGetLastError();
}

constexpr int kCoreBlockQ = prefill_core::kBlockQ;

// Checks the C entry points' shape arguments; `max_block_q` is the query
// tile of the loop the call takes (kCoreBlockQ, or kMmaBlockQ). `start` and
// `valid` are device values, never read on the host: the kernels clamp
// them (`load_chunk_bounds`); here they must only be pointers.
inline bool prefill_args_ok(int c, int nh, int dh, int ps, int maxp,
                            const int* start, const int* valid, int block_q,
                            int max_block_q) {
  return c > 0 && nh > 0 && dh > 0 && dh <= 256 && ps > 0 && maxp > 0 &&
         (long long)maxp * ps <= 0x7fffffff - c && start != nullptr &&
         valid != nullptr && block_q > 0 && block_q <= max_block_q;
}

}  // namespace paddle_tpu_torch
