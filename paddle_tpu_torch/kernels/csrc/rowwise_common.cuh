// Device helpers shared by the row-wise kernels (fused_layernorm_fwd.cu,
// fused_layernorm_bwd.cu, rotary.cu, dropout.cu): packed loads and stores
// of a few neighbouring elements as f32, and the row teams of the two
// layernorm kernels (the team shape, the team-wide sum, the rows a team has
// in flight, staged in shared memory by cp.async, and what a launch asks
// of the runtime).
//
// A row of d elements is cut into chunks of VEC neighbouring elements
// (VEC = 16 bytes of the element type where every pointer is 16-byte
// aligned and d is a multiple of VEC, else 1).
#pragma once

#include <cstdint>
#include <initializer_list>
#include <mutex>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace paddle_tpu_torch {
namespace rowwise {

constexpr int kMaxThreads = 256;
constexpr int kMaxD = 8192;   // the widest row the layernorm kernels take

// VEC neighbouring elements, loaded or stored in one instruction where
// they span at most 16 bytes (two where they span 32: 8 floats).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC <= 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(float (&out)[VEC],
                                         const T* __restrict__ p) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_float<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// True when every pointer is 16-byte aligned (null pointers pass).
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// ---- Row teams (the layernorm kernels) ----
//
// A row of `chunks` chunks is held by a team of `tw` warps: team lane l
// (0 <= l < 32 tw) holds chunks l, l + 32 tw, ..., `nc` of them, so that a
// warp's loads of one slot cover 32 neighbouring chunks. Up to 1024
// elements (512 on the scalar path, whose lanes hold one element a chunk) a
// warp holds a row: tw = 1, nc = ceil(chunks / 32), at most kWarpRowElems
// elements a lane (kTeamElems on the scalar path, where nc is rounded up
// to a power of two to bound the instantiations); a block of `block_warps`
// warps holds that many teams. A wider row takes kTeamElems a lane (nc =
// kTeamElems / vec) and tw = ceil(chunks / (32 nc)) warps, 2 to 16, with
// max(1, kTeamBlockWarps / tw) teams a block of at most kMaxTeamThreads.
// kernels/cuda/fused_layernorm.py::team_shape mirrors this.
constexpr int kWarpRowElems = 32;
constexpr int kTeamElems = 16;
constexpr int kMaxTeamThreads = kMaxD / kTeamElems;   // 16 warps
constexpr int kTeamBlockWarps = kMaxTeamThreads / 32;  // a wide row's block

struct TeamShape {
  int nc, tw, teams;
};

__host__ inline TeamShape team_shape(int chunks, int vec, int block_warps) {
  if (chunks <= 32 * (vec == 1 ? kTeamElems : kWarpRowElems / vec)) {
    int nc = (chunks + 31) / 32;
    if (vec == 1)
      for (int p = 1;; p *= 2)
        if (p >= nc) {
          nc = p;
          break;
        }
    return {nc, 1, block_warps};
  }
  const int nc = kTeamElems / vec;
  const int tw = (chunks + 32 * nc - 1) / (32 * nc);
  const int teams = kTeamBlockWarps / tw;
  return {nc, tw, teams > 1 ? teams : 1};
}

// The barrier of the team of `tw` warps that holds a row (team `team` of
// its block): __syncwarp for one warp, else named barrier 1 + team.
__device__ __forceinline__ void team_bar(int tw, int team) {
  if (tw == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * tw) : "memory");
}

// Sums each of v[0..N) over the team of `tw` warps that holds a row (team
// `team` of its block, warps team * tw ... team * tw + tw - 1); every
// thread of the team ends with the same sums, added in the same order: the
// butterfly within each warp, then the team's warps in turn. With one warp
// no barrier is taken. Above one, the warps meet in `red` (tw * N floats of
// shared memory) at `team_bar`. A caller alternates two such buffers from
// one call to the next, so that one barrier a call is enough: a thread
// writes a buffer again only after every thread of its team has passed the
// barrier of the call between, and so has read it.
template <int N>
__device__ __forceinline__ void team_sum(float (&v)[N], int tw, int team,
                                         float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (tw == 1) return;
  const int w = (threadIdx.x >> 5) - team * tw;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[w * N + i] = v[i];
  }
  team_bar(tw, team);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int j = 0; j < tw; ++j) s += red[j * N + i];
    v[i] = s;
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory: above 48 KB with
// its static shared memory (under 1 KB in the layernorm kernels) a kernel
// must ask. Returns the error of the request.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// What a launch of one kernel instantiation needs from the runtime: the
// result of its request for dynamic shared memory (`allow_smem`), the
// device's SMs, and the kernel's blocks an SM at the launch's threads and
// bytes.
struct LaunchFacts {
  cudaError_t err;
  int sms, per_sm;
};

// LaunchFacts asked of the runtime once for each device and team width,
// then kept. Within one kernel instantiation the team width alone fixes a
// launch's threads and bytes, so a launch makes no runtime call but
// cudaGetDevice, the launch itself and cudaGetLastError. The shared-memory
// limit, though, is one value a kernel and device, and the team widths of
// one instantiation ask for different bytes: it is raised to the most any
// of them asked and never lowered. One cache a kernel instantiation (a
// static of its `run`); std::call_once and a mutex make it safe to share
// between host threads. A device past the first kCachedDevices is asked
// at every launch.
class LaunchCache {
 public:
  template <typename K>
  LaunchFacts get(K kernel, int tw, int threads, size_t smem) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= kCachedDevices || tw < 1 || tw > kMaxTeamWarps)
      return ask(kernel, threads, smem, dev, allow_smem(kernel, smem));
    std::call_once(once_[dev][tw], [&] {
      facts_[dev][tw] =
          ask(kernel, threads, smem, dev, allow_up_to(kernel, smem, dev));
    });
    return facts_[dev][tw];
  }

 private:
  static constexpr int kCachedDevices = 16;
  static constexpr int kMaxTeamWarps = kMaxTeamThreads / 32;

  template <typename K>
  cudaError_t allow_up_to(K kernel, size_t smem, int dev) {
    std::lock_guard<std::mutex> lock(mutex_);
    if (smem <= allowed_[dev]) return cudaSuccess;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess) allowed_[dev] = smem;
    return err;
  }

  template <typename K>
  static LaunchFacts ask(K kernel, int threads, size_t smem, int dev,
                         cudaError_t err) {
    LaunchFacts f{err, 0, 0};
    cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel, threads,
                                                  smem);
    return f;
  }

  std::once_flag once_[kCachedDevices][kMaxTeamWarps + 1];
  LaunchFacts facts_[kCachedDevices][kMaxTeamWarps + 1];
  std::mutex mutex_;
  size_t allowed_[kCachedDevices] = {};   // bytes the limit allows
};

// A team's rows staged in shared memory, STAGES of them, each of A arrays
// (x; or x and dy), all by 16-byte cp.async, so that the copies of the
// next STAGES - 1 rows are in flight while the team reduces the current
// one and no register holds them. A staged row lies in its slot as in
// device memory: `row` gives its element 0, and chunk c of VEC elements
// sits at row + c VEC.
// - The vector path (16 bytes a chunk, every pointer and d * sizeof(T)
//   16-byte aligned): team lane l copies its own chunks l + i * tt, and
//   reads only them, so its own cp.async groups order its copies and
//   reads, and no barrier is needed.
// - The scalar path (VEC = 1: odd d, or tensors off 16 bytes): the team
//   copies the aligned 16-byte blocks of device memory that hold the row,
//   lane l blocks l, l + tt, ..., and the row starts (its address mod 16)
//   bytes into its slot. A block that reaches outside the tensor (only
//   the first row's first and the last row's last can) is copied element
//   by element, the row's own elements alone, by plain loads; no byte
//   outside the tensor is read. A lane reads elements other lanes copied,
//   so the caller calls `sync` between the wait for a row's copies and its
//   reads; the same barrier keeps the next copies into a slot behind every
//   lane's reads of the row it held before.
template <typename T, int VEC, int NC, int A, int STAGES>
struct RowStages {
  static constexpr bool kScalar = VEC == 1;
  static_assert(kScalar || sizeof(T) * VEC == 16, "16-byte chunks");
  unsigned char* base;   // the team's STAGES * A slots
  int tt, l, d;          // threads a team, the team lane, elements a row

  // a slot: a row of NC * tt chunks, and on the scalar path up to two
  // blocks more for the row's start and end within their 16 bytes
  __host__ __device__ static constexpr size_t slot_bytes(int tt) {
    return kScalar ? ((size_t)NC * tt * sizeof(T) + 32 + 15) / 16 * 16
                   : sizeof(Pack<T, VEC>) * NC * tt;
  }
  __host__ __device__ static constexpr size_t bytes(int tt) {
    return STAGES * A * slot_bytes(tt);
  }

  __device__ __forceinline__ unsigned char* slot(int stage, int a) const {
    return base + (size_t)(stage * A + a) * slot_bytes(tt);
  }

  // Issues this lane's copies of row `row` of `src` [n, d] into the slot
  // of (stage, a).
  __device__ __forceinline__ void copy(int stage, int a,
                                       const T* __restrict__ src,
                                       long long row, long long n) {
    unsigned char* dst = slot(stage, a);
    const T* r = src + row * d;
    if constexpr (kScalar) {
      const char* lo = reinterpret_cast<const char*>(src);
      const char* hi = reinterpret_cast<const char*>(src + n * d);
      const char* rb = reinterpret_cast<const char*>(r);
      const char* re = rb + (size_t)d * sizeof(T);
      const char* a0 = reinterpret_cast<const char*>(
          reinterpret_cast<std::uintptr_t>(rb) & ~std::uintptr_t(15));
      const int blocks = (int)((re - a0 + 15) / 16);
      for (int k = l; k < blocks; k += tt) {
        const char* c = a0 + 16 * k;
        if (c >= lo && c + 16 <= hi) {
          cp_async16(smem_addr(dst + 16 * k), c, true);
        } else {
          for (int b = 0; b < 16; b += (int)sizeof(T))
            if (c + b >= rb && c + b < re)
              *reinterpret_cast<T*>(dst + 16 * k + b) =
                  *reinterpret_cast<const T*>(c + b);
        }
      }
    } else {
      Pack<T, VEC>* packs = reinterpret_cast<Pack<T, VEC>*>(dst);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = l + i * tt;
        if (c < d / VEC)
          cp_async16(smem_addr(packs + c), r + (size_t)c * VEC, true);
      }
    }
  }

  // Element 0 of the staged row in the slot of (stage, a), whose element 0
  // lies at `at` in device memory.
  __device__ __forceinline__ const T* row(int stage, int a,
                                          const T* at) const {
    const unsigned char* s = slot(stage, a);
    if constexpr (kScalar)
      s += reinterpret_cast<std::uintptr_t>(at) & 15;
    return reinterpret_cast<const T*>(s);
  }

  // On the scalar path, the team barrier between a row's copies and its
  // reads (see above); nothing on the vector path.
  __device__ __forceinline__ void sync(int tw, int team) const {
    if constexpr (kScalar) team_bar(tw, team);
  }
};

}  // namespace rowwise
}  // namespace paddle_tpu_torch
