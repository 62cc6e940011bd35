// Fused multi-tensor SGD for Hopper (sm_90a), bound through a plain C
// interface: one launch updates every parameter leaf of a model.
//
// Replaces: distkeras_tpu/ops/pallas_kernels.py `_sgd_kernel` (launched per
// leaf by `_leaf_sgd` through `pl.pallas_call`) and `_sgd_momentum_kernel`
// (`_leaf_sgd_momentum`), from `FusedSGD.fused_apply` (optimizer
// "pallas_sgd", momentum 0 and momentum > 0).
//
// Math (identical to the JAX kernels and to the port's plain versions
// `sgd_step_plain` / `sgd_momentum_step_plain`), per element in f32, in the
// same operation order, each step rounded (the __f*_rn intrinsics are never
// contracted into FMAs):
//     dk_sgd_fused:            p' = p - lr*g
//     dk_sgd_momentum_fused:   m' = mu*m + g
//                              u  = g + mu*m'  (Nesterov)  or  m'
//                              p' = p - lr*u
// p is written in its own dtype (f32, bf16 or f16; g shares it), m stays
// f32. lr, mu and the Nesterov flag are launch arguments (the TPU kernels
// baked them in; the port keeps refusing schedules, as JAX does).
//
// Bound on an H100: bytes. Per parameter, SGD reads p and g and writes p
// (12 bytes in f32, 6 in bf16/f16); momentum adds m's f32 read and write
// (20 and 14 bytes), against 2-6 FLOPs. So the design is about bytes in
// flight. ONE launch per step walks every leaf (the TPU path launched one
// pallas_call per leaf): the caller builds, once per set of parameters, a
// device table of leaves ([p, n] or [p, m, n]) and one of chunks (leaf,
// start), a chunk being 16 KiB of p (4096 f32 or 8192 bf16/f16 elements:
// 256 threads x 4 packs of 16 bytes). The gradients' pointers sit in a
// table of their own, uploaded again only when autograd moves them.
//   - Every access is a 16-byte pack for every dtype: 4 f32 or 8 bf16/f16
//     values, converted in pairs (__bfloat1622float2/__floats2bfloat162_rn,
//     __half22float2/__floats2half2_rn, which round exactly as the scalar
//     __float2bfloat16_rn/__float2half_rn), m as one or two float4.
//   - A thread issues every load of its 4 packs (p, g and m) before any
//     math: 128 bytes (SGD) to 256 (bf16 with momentum) in flight per
//     thread, with streaming cache hints (__ldcs/__stcs: each byte is read
//     or written once).
//   - The next chunk's table entry is read before the current chunk's data
//     and its leaf's pointers right after the data loads are issued, so
//     the three dependent table reads stay off the critical path.
//   - The grid is persistent: SM count x resident blocks
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), computed once per
//     kernel and device by the launcher; the blocks walk the chunks with a
//     grid stride.
//   - A chunk whose p, g or m is not 16-byte aligned (a contiguous view at
//     an element offset: ZeRO-1 slices, TP shards, member-stacked views)
//     and a chunk's last len % pack elements take a scalar path.
// The JAX package's small-leaf cutoff (`_MIN_KERNEL_SIZE`, a TPU
// launch-cost choice) is gone: the math is identical, so every leaf takes
// the kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// 16-byte packs of p a thread moves per chunk
constexpr int kPacks = 4;
// bytes of p in one chunk of the table
constexpr int kChunkBytes = kThreads * kPacks * 16;
constexpr int kMaxDevices = 64;

template <typename T>
constexpr int kPackElems = 16 / (int)sizeof(T);
template <typename T>
constexpr int kChunkElems = kChunkBytes / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of T <-> kPackElems<T> floats; the pair conversions round as the
// scalar ones do.
template <typename T>
struct PackIO;
template <>
struct PackIO<float> {
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <typename Pair>
struct PairIO {
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      typename Pair::P h;
      memcpy(&h, &w[i], 4);
      const float2 v = Pair::to_f2(h);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const typename Pair::P h = Pair::from_f2(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, 4);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
struct Bf16Pair {
  using P = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_f2(P h) {
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ P from_f2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
struct HalfPair {
  using P = __half2;
  static __device__ __forceinline__ float2 to_f2(P h) {
    return __half22float2(h);
  }
  static __device__ __forceinline__ P from_f2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};
template <>
struct PackIO<__nv_bfloat16> : PairIO<Bf16Pair> {};
template <>
struct PackIO<__half> : PairIO<HalfPair> {};

__device__ __forceinline__ float sgd(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

__device__ __forceinline__ float sgd_momentum(float p, float g, float& m,
                                              float lr, float mu,
                                              bool nesterov) {
  m = __fadd_rn(__fmul_rn(mu, m), g);
  const float u = nesterov ? __fadd_rn(g, __fmul_rn(mu, m)) : m;
  return __fsub_rn(p, __fmul_rn(lr, u));
}

// The update of one element: B1 (kMom false) or B2.
template <bool kMom>
struct Step {
  float lr, mu;
  int nesterov;
  __device__ __forceinline__ float operator()(float p, float g,
                                              float& m) const {
    if constexpr (kMom) {
      return sgd_momentum(p, g, m, lr, mu, nesterov != 0);
    } else {
      return sgd(p, g, lr);
    }
  }
};

// One chunk of one leaf: its p, g and (B2) m at the chunk's first element,
// and its length.
template <typename T>
struct Chunk {
  T* p;
  const T* g;
  float* m;
  int len;
};

// The chunk table's entry ci: (leaf, start).
__device__ __forceinline__ longlong2 chunk_entry(const long long* chunks,
                                                 int ci) {
  return __ldg(reinterpret_cast<const longlong2*>(chunks) + ci);
}

template <typename T, bool kMom>
__device__ __forceinline__ Chunk<T> resolve(const long long* leaves,
                                            const long long* grads,
                                            longlong2 e) {
  constexpr int kCols = kMom ? 3 : 2;
  const long long* leaf = leaves + kCols * e.x;
  Chunk<T> c;
  c.p = reinterpret_cast<T*>(__ldg(leaf)) + e.y;
  c.m = kMom ? reinterpret_cast<float*>(__ldg(leaf + 1)) + e.y : nullptr;
  c.g = reinterpret_cast<const T*>(__ldg(grads + e.x)) + e.y;
  c.len = (int)min((long long)kChunkElems<T>, __ldg(leaf + kCols - 1) - e.y);
  return c;
}

template <typename T>
__device__ __forceinline__ bool aligned(const Chunk<T>& c) {
  return ((reinterpret_cast<uintptr_t>(c.p) |
           reinterpret_cast<uintptr_t>(c.g) |
           reinterpret_cast<uintptr_t>(c.m)) & 15) == 0;
}

// Elements [from, len) of a chunk, one at a time.
template <typename T, bool kMom>
__device__ __forceinline__ void scalar_range(const Chunk<T>& c, int from,
                                             const Step<kMom>& op) {
  for (int i = from + threadIdx.x; i < c.len; i += kThreads) {
    float m = kMom ? c.m[i] : 0.f;
    c.p[i] = from_f32<T>(op(to_f32(c.p[i]), to_f32(c.g[i]), m));
    if constexpr (kMom) c.m[i] = m;
  }
}

// The update of one 16-byte pack of p and g (and its m floats) in registers.
template <typename T, bool kMom>
__device__ __forceinline__ uint4 update_pack(const uint4& pr, const uint4& gr,
                                             float4* mr,
                                             const Step<kMom>& op) {
  constexpr int E = kPackElems<T>;
  float pf[E], gf[E], mf[E];
  PackIO<T>::unpack(pr, pf);
  PackIO<T>::unpack(gr, gf);
  if constexpr (kMom) memcpy(mf, mr, sizeof(mf));
#pragma unroll
  for (int e = 0; e < E; ++e) pf[e] = op(pf[e], gf[e], mf[e]);
  if constexpr (kMom) memcpy(mr, mf, sizeof(mf));
  return PackIO<T>::pack(pf);
}

template <typename T, bool kMom>
struct Regs {
  static constexpr int kM = kMom ? kPackElems<T> / 4 : 0;  // float4 a pack
  uint4 p[kPacks], g[kPacks];
  float4 m[kPacks][kM > 0 ? kM : 1];
};

template <typename T, bool kMom>
__device__ __forceinline__ void load_packs(const Chunk<T>& c, int packs,
                                           Regs<T, kMom>& r) {
  constexpr int kM = Regs<T, kMom>::kM;
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < packs) {
      r.p[u] = __ldcs(reinterpret_cast<const uint4*>(c.p) + j);
      r.g[u] = __ldcs(reinterpret_cast<const uint4*>(c.g) + j);
#pragma unroll
      for (int q = 0; q < kM; ++q) {
        r.m[u][q] = __ldcs(reinterpret_cast<const float4*>(c.m) + kM * j + q);
      }
    }
  }
}

template <typename T, bool kMom>
__device__ __forceinline__ void store_packs(const Chunk<T>& c, int packs,
                                            Regs<T, kMom>& r,
                                            const Step<kMom>& op) {
  constexpr int kM = Regs<T, kMom>::kM;
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < packs) {
      __stcs(reinterpret_cast<uint4*>(c.p) + j,
             update_pack<T, kMom>(r.p[u], r.g[u], r.m[u], op));
#pragma unroll
      for (int q = 0; q < kM; ++q) {
        __stcs(reinterpret_cast<float4*>(c.m) + kM * j + q, r.m[u][q]);
      }
    }
  }
}

template <typename T, bool kMom>
__device__ __forceinline__ void walk(const long long* leaves,
                                     const long long* grads,
                                     const long long* chunks, int n_chunks,
                                     const Step<kMom>& op) {
  constexpr int E = kPackElems<T>;
  int ci = blockIdx.x;
  Chunk<T> cur = resolve<T, kMom>(leaves, grads, chunk_entry(chunks, ci));
  for (;;) {
    const int nci = ci + gridDim.x;
    const bool more = nci < n_chunks;
    longlong2 entry = make_longlong2(0, 0);
    if (more) entry = chunk_entry(chunks, nci);
    const bool vec = aligned(cur);
    const int packs = vec ? cur.len / E : 0;
    Regs<T, kMom> r;
    load_packs<T, kMom>(cur, packs, r);
    Chunk<T> nxt = cur;
    if (more) nxt = resolve<T, kMom>(leaves, grads, entry);
    store_packs<T, kMom>(cur, packs, r, op);
    scalar_range<T, kMom>(cur, packs * E, op);
    if (!more) return;
    ci = nci;
    cur = nxt;
  }
}

// leaves: (L, 2) int64 [p, n]; grads: (L,) int64 g pointers; chunks:
// (C, 2) int64 [leaf, start].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgd_fused_kernel(const long long* __restrict__ leaves,
                     const long long* __restrict__ grads,
                     const long long* __restrict__ chunks, int n_chunks,
                     Step<false> op) {
  walk<T, false>(leaves, grads, chunks, n_chunks, op);
}

// leaves: (L, 3) int64 [p, m, n]; grads and chunks as above.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgd_momentum_fused_kernel(const long long* __restrict__ leaves,
                              const long long* __restrict__ grads,
                              const long long* __restrict__ chunks,
                              int n_chunks, Step<true> op) {
  walk<T, true>(leaves, grads, chunks, n_chunks, op);
}

// The persistent grid of one kernel on the current device: SM count x the
// blocks of it one SM holds, at most n_chunks; computed once per kernel and
// device.
template <typename T, bool kMom, typename K>
int persistent_grid(K kernel, int n_chunks) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = dev < kMaxDevices ? cached[dev] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < kMaxDevices) cached[dev] = blocks;
  }
  return n_chunks < blocks ? n_chunks : blocks;
}

// chunk is the table's chunk length, checked here and not a choice of the
// launch: the table builder (ops/pallas_kernels.py, SGD_CHUNK_BYTES) and
// kChunkBytes must change together, and a table cut otherwise is refused.
template <typename T, bool kMom>
int launch(const void* leaves, const void* grads, const void* chunks,
           int n_chunks, int chunk, Step<kMom> op, void* stream) {
  if (n_chunks < 1 || chunk != kChunkElems<T>) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* lv = static_cast<const long long*>(leaves);
  const auto* gp = static_cast<const long long*>(grads);
  const auto* ck = static_cast<const long long*>(chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kMom) {
    const int grid =
        persistent_grid<T, kMom>(sgd_momentum_fused_kernel<T>, n_chunks);
    sgd_momentum_fused_kernel<T><<<grid, kThreads, 0, s>>>(lv, gp, ck,
                                                           n_chunks, op);
  } else {
    const int grid = persistent_grid<T, kMom>(sgd_fused_kernel<T>, n_chunks);
    sgd_fused_kernel<T><<<grid, kThreads, 0, s>>>(lv, gp, ck, n_chunks, op);
  }
  return (int)cudaGetLastError();
}

template <bool kMom>
int dispatch(const void* leaves, const void* grads, const void* chunks,
             int n_chunks, int chunk, Step<kMom> op, int dtype,
             void* stream) {
  switch (dtype) {
    case 0:
      return launch<float, kMom>(leaves, grads, chunks, n_chunks, chunk, op,
                                 stream);
    case 1:
      return launch<__nv_bfloat16, kMom>(leaves, grads, chunks, n_chunks,
                                         chunk, op, stream);
    case 2:
      return launch<__half, kMom>(leaves, grads, chunks, n_chunks, chunk, op,
                                  stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of every p and g): 0 = float32, 1 = bfloat16, 2 = float16. leaves
// is a device int64 (L, 2) table [p, n] (every buffer contiguous); grads a
// device int64 (L,) table of the gradients' pointers (g of leaf l has n
// elements); chunks a device int64 (n_chunks, 2) table [leaf, start]
// cutting each leaf into pieces of `chunk` elements (the last shorter),
// chunk being the kernel's own: 16 KiB of the dtype, 4096 f32 or 8192
// bf16/f16. It is passed only to be checked; any other value is refused.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int dk_sgd_fused(const void* leaves, const void* grads,
                            const void* chunks, int n_chunks, int chunk,
                            float lr, int dtype, void* stream) {
  return dispatch<false>(leaves, grads, chunks, n_chunks, chunk,
                         Step<false>{lr, 0.f, 0}, dtype, stream);
}

// As dk_sgd_fused, with leaves a device int64 (L, 3) table [p, m, n] (m
// float32, contiguous, updated in place); nesterov 0 or 1.
extern "C" int dk_sgd_momentum_fused(const void* leaves, const void* grads,
                                     const void* chunks, int n_chunks,
                                     int chunk, float lr, float mu,
                                     int nesterov, int dtype, void* stream) {
  return dispatch<true>(leaves, grads, chunks, n_chunks, chunk,
                        Step<true>{lr, mu, nesterov}, dtype, stream);
}
