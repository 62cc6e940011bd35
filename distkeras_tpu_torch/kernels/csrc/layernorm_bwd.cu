// LayerNorm backward for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces: distkeras_tpu/ops/fused_layernorm.py `_bwd_kernel`, launched by
// `_bwd` through `pl.pallas_call` (the custom VJP behind
// `fused_layer_norm`).
//
// Math (identical to the JAX kernel and to the port's plain version
// `_reference_layer_norm_bwd`): per row of x (rows, D), f32 compute,
// recomputing the statistics from x instead of saving them,
//     mean = sum(x) / D,  var = sum((x - mean)^2) / D,  rstd = rsqrt(var + eps)
//     xhat = (x - mean) * rstd,  a = dy * gamma
//     dx = rstd * (a - mean(a) - xhat * mean(a * xhat))    (in x's dtype)
// and dgamma = sum(dy * xhat), dbeta = sum(dy) over the rows, in f32. Each
// block sums its rows into a partial row of (2, nblocks, D); the same
// launch then folds the partial rows (below), so the caller launches
// nothing more. No float atomics: every sum runs in a fixed order, so
// dgamma/dbeta are the same bits from run to run.
//
// Bound on an H100: bytes. x and dy are read once and dx written once; the
// arithmetic is ~20 FLOPs per element. The design keeps HBM busy:
//   * D <= 1024: one warp per row, 8 warps per 256-thread block, each warp
//     walking rows with a grid stride and keeping the row in registers
//     between its reductions. Rows load as 16-byte vectors (float4 in
//     f32, 8 halves in bf16/f16; a lane owns whole vectors); a D that is
//     not a multiple of the vector width, or an unaligned row, takes
//     element loads instead. Up to D = 512 a thread needs at most 128
//     registers, so two blocks share an SM: 16 warps, each with a row
//     (4 KB at D = 512 f32) in flight — at (4096, 512), 256 blocks in one
//     wave, two rows per warp. Issuing the next row's loads before this
//     row's reductions measured no faster (it spilled at 128 registers).
//     Gamma sits in shared memory; the warps' dgamma/dbeta column sums
//     stay in registers and meet once, at the end, through a shared
//     buffer sized by D (gamma, then 8 x D floats for dgamma and again for
//     dbeta).
//   * D > 1024: one 256-thread block walks its rows with block reductions
//     through shared memory and re-reads the row from device memory
//     (L2-resident); thread c owns columns c, c+256, ... of the block's
//     partial row, which it accumulates in place (scalar loads).
//   * The fold, in the same launch, deterministic and CUDA-graph-safe:
//     after writing its partial row a block takes a ticket from its
//     group's counter (groups of 16 blocks); the group's last block adds
//     the group's rows in block order into the group's first row, then
//     takes a ticket from a second counter; the last group adds the group
//     rows in group order into row 0. Each last arrival resets its counter
//     to 0, so the next launch (or graph replay) starts clean. Each thread
//     of a folding block issues its 16 loads (float4 columns) at once, so
//     a level costs about three L2 round trips (the ticket, the loads, the
//     store) after the last block's own work; the tail is latency, not
//     bytes. The counters are device globals of this library: launches of
//     this kernel on two streams at once would share them, so the caller
//     keeps them on one stream (the port launches on the current stream).
//   * Where the time goes at (4096, 512) f32 is measured by
//     ln_bwd_breakdown.py (builds of this source without the fold and
//     without the partial rows, timed beside it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kWarps = 8;          // warps per block, warp kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockThreads = 256;  // threads per block, block kernel
constexpr int kMaxBlocks = 65535;
constexpr int kGroup = 16;          // blocks per first-level fold group
constexpr int kGroups = (kMaxBlocks + kGroup - 1) / kGroup;

// fold tickets: one counter per group, then the second level's; zero
// between launches (each last arrival resets its own)
__device__ unsigned int g_tickets[kGroups + 1];

// ------------------------------------------------------------------ fold

// Every thread of the block calls this after the block's writes; true in
// the block that arrives n-th of n at `ticket`. Thread 0 takes the ticket
// with one acquire-release atomic: the release publishes the block's
// writes (the barrier orders them before it), the acquire orders the
// reads the last block makes next (the second barrier carries it to all).
__device__ __forceinline__ bool last_arrival(unsigned int* ticket,
                                             unsigned int n) {
  __shared__ unsigned int s_ticket;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int t;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(t)
                 : "l"(ticket)
                 : "memory");
    s_ticket = t;
  }
  __syncthreads();
  return s_ticket == n - 1;
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// p[at], p[at + stride], ... (count of them) added in that order into
// p[at], as V (float or float4); the loads go out kGroup at a time, from
// L2 (__ldcg), since other SMs wrote them
template <typename V>
__device__ __forceinline__ void sum_strided(float* p, long long at,
                                            long long stride, int count) {
  V acc{};
  for (int i0 = 0; i0 < count; i0 += kGroup) {
    V v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (i0 + u < count)
        v[u] = __ldcg(reinterpret_cast<const V*>(p + at + (i0 + u) * stride));
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (i0 + u < count) add_to(acc, v[u]);
  }
  *reinterpret_cast<V*>(p + at) = acc;
}

// rows first, first + step, ... (count of them) added in that order into
// row `first`, for dgamma (pg) and dbeta (pb): each thread owns one
// 4-column group (one column where d % 4 != 0) of one of the two
__device__ __forceinline__ void sum_rows(float* pg, float* pb, int first,
                                         int step, int count, int d) {
  const bool vec =  // 16-byte aligned rows
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(pg) & 15) == 0;
  const int w = vec ? d >> 2 : d;
  const long long stride = (long long)step * d;
  for (int item = threadIdx.x; item < 2 * w; item += blockDim.x) {
    float* p = item < w ? pg : pb;
    const long long at =
        (long long)first * d + (item < w ? item : item - w) * (vec ? 4 : 1);
    if (vec)
      sum_strided<float4>(p, at, stride, count);
    else
      sum_strided<float>(p, at, stride, count);
  }
}

// partials (2, nblocks, d): each block's partial rows written; on return
// from the last block, row 0 of each half holds the total
__device__ void fold_partials(float* partials, int nblocks, int d) {
  float* pg = partials;
  float* pb = partials + (long long)nblocks * d;
  const int grp = blockIdx.x / kGroup, first = grp * kGroup;
  const int members = min(kGroup, nblocks - first);
  const int ngroups = (nblocks + kGroup - 1) / kGroup;
  if (nblocks == 1) return;  // the block's own row is row 0
  if (!last_arrival(&g_tickets[grp], members)) return;
  if (threadIdx.x == 0) g_tickets[grp] = 0;  // every member has arrived
  sum_rows(pg, pb, first, 1, members, d);
  if (ngroups == 1) return;  // the group's first row is row 0
  if (!last_arrival(&g_tickets[kGroups], ngroups)) return;
  if (threadIdx.x == 0) g_tickets[kGroups] = 0;
  sum_rows(pg, pb, 0, kGroup, ngroups, d);
}

// ------------------------------------------------------ warp kernel rows

// Value i of a lane's NPL lies at column col<...>(lane, i): with VEC, lane
// owns whole 16-byte vectors lane, lane + 32, ...; else columns lane,
// lane + 32, ...
template <typename T, bool VEC>
__device__ __forceinline__ int col(int lane, int i) {
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  return (lane + 32 * (i / V)) * V + i % V;
}

// a row's values (0 past d)
template <typename T, int NPL, bool VEC>
__device__ __forceinline__ void load_row(float (&out)[NPL],
                                         const T* __restrict__ row, int d,
                                         int lane) {
  if constexpr (VEC) {
    constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
    for (int vi = 0; vi < NPL / V; ++vi) {
      const int c0 = (lane + 32 * vi) * V;
      if (c0 < d) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + c0));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) out[vi * V + j] = to_f32(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) out[vi * V + j] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      out[i] = c < d ? to_f32(row[c]) : 0.f;
    }
  }
}

template <typename T, int NPL, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ row,
                                          const float (&val)[NPL], int d,
                                          int lane) {
  if constexpr (VEC) {
    constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
    for (int vi = 0; vi < NPL / V; ++vi) {
      const int c0 = (lane + 32 * vi) * V;
      if (c0 < d) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = from_f32<T>(val[vi * V + j]);
        *reinterpret_cast<uint4*>(row + c0) = raw;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < d) row[c] = from_f32<T>(val[i]);
    }
  }
}

// One warp per row; NPL values per lane cover D <= 32 * NPL. Rows
// blockIdx.x * kWarps + warp, then + gridDim.x * kWarps, ...
template <typename T, int NPL, bool VEC>
__global__ void __launch_bounds__(kThreads, NPL <= 16 ? 2 : 1)
    ln_bwd_warp(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ gamma, T* __restrict__ dx,
                float* __restrict__ partials, long long rows, int d,
                float eps) {
  extern __shared__ float smem[];
  float* sg = smem;      // [d] gamma
  float* red = sg + d;   // [kWarps][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_d = 1.f / (float)d;
  for (int c = threadIdx.x; c < d; c += kThreads) sg[c] = gamma[c];
  float dg[NPL], db[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) dg[i] = db[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + warp;
  for (; row < rows; row += stride) {
    float xv[NPL], dyv[NPL];
    load_row<T, NPL, VEC>(xv, x + row * d, d, lane);
    load_row<T, NPL, VEC>(dyv, dy + row * d, d, lane);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) s += xv[i];
    const float mean = warp_sum(s) * inv_d;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const float t = col<T, VEC>(lane, i) < d ? xv[i] - mean : 0.f;
      ss += t * t;
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
    float sa = 0.f, sax = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = col<T, VEC>(lane, i);
      xv[i] = (xv[i] - mean) * rstd;  // xhat (finite past d, where dy == 0)
      dg[i] += dyv[i] * xv[i];
      db[i] += dyv[i];
      dyv[i] *= c < d ? sg[c] : 0.f;  // a = dy * gamma from here on
      sa += dyv[i];
      sax += dyv[i] * xv[i];
    }
    const float m1 = warp_sum(sa) * inv_d;
    const float m2 = warp_sum(sax) * inv_d;
#pragma unroll
    for (int i = 0; i < NPL; ++i) xv[i] = rstd * (dyv[i] - m1 - xv[i] * m2);
    store_row<T, NPL, VEC>(dx + row * d, xv, d, lane);
  }
  // the block's partial rows: dgamma, then dbeta, each through red
  const int tid = threadIdx.x;
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = col<T, VEC>(lane, i);
      if (c < d) red[warp * d + c] = half == 0 ? dg[i] : db[i];
    }
    __syncthreads();
    float* dst = partials + ((long long)half * gridDim.x + blockIdx.x) * d;
    for (int c = tid; c < d; c += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[w * d + c];
      dst[c] = a;
    }
    __syncthreads();  // red is rewritten by the next half
  }
  fold_partials(partials, gridDim.x, d);
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// One block walks rows blockIdx.x, + gridDim.x, ..., for D > 1024.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    ln_bwd_block(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma, T* __restrict__ dx,
                 float* __restrict__ partials, long long rows, int d,
                 float eps) {
  __shared__ float red[32];
  const float inv_d = 1.f / (float)d;
  float* pg = partials + (long long)blockIdx.x * d;
  float* pb = partials + ((long long)gridDim.x + blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) pg[c] = pb[c] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) s += to_f32(xr[c]);
    const float mean = block_sum(s, red) * inv_d;
    float ss = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float t = to_f32(xr[c]) - mean;
      ss += t * t;
    }
    const float rstd = rsqrtf(block_sum(ss, red) * inv_d + eps);
    float sa = 0.f, sax = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - mean) * rstd;
      const float a = to_f32(dyr[c]) * gamma[c];
      sa += a;
      sax += a * xh;
    }
    const float m1 = block_sum(sa, red) * inv_d;
    const float m2 = block_sum(sax, red) * inv_d;
    T* dxr = dx + row * d;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - mean) * rstd;
      const float dyv = to_f32(dyr[c]);
      dxr[c] = from_f32<T>(rstd * (dyv * gamma[c] - m1 - xh * m2));
      pg[c] += dyv * xh;  // column c belongs to this thread alone
      pb[c] += dyv;
    }
  }
  fold_partials(partials, gridDim.x, d);
}

// NPL values per lane; the vector path needs whole vectors per lane
template <typename T, int NPL>
void launch_warp(bool vec, const void* x, const void* dy, const float* g,
                 void* dx, float* part, long long rows, int d, float eps,
                 int nblocks, cudaStream_t s) {
  const size_t smem = (size_t)(kWarps + 1) * d * sizeof(float);  // <= 36 KB
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if constexpr (NPL * sizeof(T) >= 16) {
    if (vec) {
      ln_bwd_warp<T, NPL, true><<<nblocks, kThreads, smem, s>>>(
          xt, dyt, g, dxt, part, rows, d, eps);
      return;
    }
  }
  ln_bwd_warp<T, NPL, false><<<nblocks, kThreads, smem, s>>>(
      xt, dyt, g, dxt, part, rows, d, eps);
}

template <typename T>
void launch(const void* x, const void* dy, const float* g, void* dx,
            float* part, long long rows, int d, float eps, int nblocks,
            cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  // 16-byte vectors need rows of whole vectors and aligned bases
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  int npl = (d + 31) / 32;
  if (vec && npl < V) npl = V;
  if (npl <= 1) return launch_warp<T, 1>(vec, x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 2) return launch_warp<T, 2>(vec, x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 4) return launch_warp<T, 4>(vec, x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 8) return launch_warp<T, 8>(vec, x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 16) return launch_warp<T, 16>(vec, x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 32) return launch_warp<T, 32>(vec, x, dy, g, dx, part, rows, d, eps, nblocks, s);
  ln_bwd_block<T><<<nblocks, kBlockThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g,
      static_cast<T*>(dx), part, rows, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x, dy and dx are
// contiguous (rows, d) in that dtype; gamma is contiguous float32 (d,);
// partials is contiguous float32 (2, nblocks, d), the kernel's workspace:
// each block writes its partial rows there and the fold leaves dgamma in
// partials[0][0] and dbeta in partials[1][0]. Returns the CUDA error code
// of the launch (0 = launched).
extern "C" int dk_layernorm_bwd(const void* x, const void* dy,
                                const void* gamma, void* dx, void* partials,
                                long long rows, int d, float eps,
                                int nblocks, int dtype, void* stream) {
  if (rows < 1 || d < 1 || nblocks < 1 || nblocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* part = static_cast<float*>(partials);
  switch (dtype) {
    case 0: launch<float>(x, dy, g, dx, part, rows, d, eps, nblocks, s); break;
    case 1: launch<__nv_bfloat16>(x, dy, g, dx, part, rows, d, eps, nblocks, s); break;
    case 2: launch<__half>(x, dy, g, dx, part, rows, d, eps, nblocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
