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
// and per-block partial sums dgamma = sum(dy * xhat), dbeta = sum(dy) over
// the block's rows, written as f32 (2, nblocks, D) and reduced by the
// caller (as the JAX package reduces its partials in XLA). No atomics: every
// column of a block's partial row is owned by one thread and summed in a
// fixed order, so dgamma/dbeta are the same from run to run.
//
// Bound on an H100: bytes. x and dy are read once and dx written once; the
// arithmetic is ~20 FLOPs per element. The design keeps the row in
// registers between the reductions, as the forward kernel does:
//   * D <= 1024: one warp per row, 4 warps per 128-thread block, each warp
//     walking kRowsPerWarp rows (grid stride) and keeping its dgamma/dbeta
//     column sums in registers; the block's 4 warps add theirs through
//     shared memory into the block's partial row.
//   * D > 1024: one 256-thread block walks its rows with block reductions
//     through shared memory and re-reads the row from device memory
//     (L2-resident); thread c owns columns c, c+256, ... of the block's
//     partial row, which it accumulates in place.
// Not yet done (a later PR): 16-byte vector loads, overlapping one row's
// loads with the previous row's arithmetic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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

constexpr int kWarps = 4;          // warps per block, warp kernel
constexpr int kBlockThreads = 256;  // threads per block, block kernel
constexpr int kMaxWarpD = 1024;

// One warp per row; NPL values per lane cover D <= 32 * NPL. Rows
// blockIdx.x * kWarps + warp, then + gridDim.x * kWarps, ...
template <typename T, int NPL>
__global__ void __launch_bounds__(32 * kWarps)
    ln_bwd_warp(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ gamma, T* __restrict__ dx,
                float* __restrict__ partials, long long rows, int d,
                float eps) {
  __shared__ float red[2][kWarps][kMaxWarpD];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const float inv_d = 1.f / (float)d;
  float g[NPL], dg[NPL], db[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    g[i] = c < d ? gamma[c] : 0.f;
    dg[i] = db[i] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    float xv[NPL], dyv[NPL];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < d ? to_f32(xr[c]) : 0.f;
      dyv[i] = c < d ? to_f32(dyr[c]) : 0.f;
      s += xv[i];
    }
    const float mean = warp_sum(s) * inv_d;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      const float t = c < d ? xv[i] - mean : 0.f;
      ss += t * t;
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
    float sa = 0.f, sax = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      xv[i] = (xv[i] - mean) * rstd;  // xhat (finite past d, where a == 0)
      const float a = dyv[i] * g[i];  // 0 past d
      sa += a;
      sax += a * xv[i];
    }
    const float m1 = warp_sum(sa) * inv_d;
    const float m2 = warp_sum(sax) * inv_d;
    T* dxr = dx + row * d;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        const float a = dyv[i] * g[i];
        dxr[c] = from_f32<T>(rstd * (a - m1 - xv[i] * m2));
        dg[i] += dyv[i] * xv[i];
        db[i] += dyv[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      red[0][warp][c] = dg[i];
      red[1][warp][c] = db[i];
    }
  }
  __syncthreads();
  const int tid = warp * 32 + lane;
  float* pg = partials + (long long)blockIdx.x * d;
  float* pb = partials + ((long long)gridDim.x + blockIdx.x) * d;
  for (int c = tid; c < d; c += 32 * kWarps) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w][c];
      b += red[1][w][c];
    }
    pg[c] = a;
    pb[c] = b;
  }
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
}

template <typename T, int NPL>
void launch_warp(const void* x, const void* dy, const float* g, void* dx,
                 float* part, long long rows, int d, float eps, int nblocks,
                 cudaStream_t stream) {
  const dim3 block(32, kWarps);
  ln_bwd_warp<T, NPL><<<nblocks, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g,
      static_cast<T*>(dx), part, rows, d, eps);
}

template <typename T>
void launch(const void* x, const void* dy, const float* g, void* dx,
            float* part, long long rows, int d, float eps, int nblocks,
            cudaStream_t s) {
  const int npl = (d + 31) / 32;
  if (npl <= 1) return launch_warp<T, 1>(x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 2) return launch_warp<T, 2>(x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 4) return launch_warp<T, 4>(x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 8) return launch_warp<T, 8>(x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 16) return launch_warp<T, 16>(x, dy, g, dx, part, rows, d, eps, nblocks, s);
  if (npl <= 32) return launch_warp<T, 32>(x, dy, g, dx, part, rows, d, eps, nblocks, s);
  ln_bwd_block<T><<<nblocks, kBlockThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g,
      static_cast<T*>(dx), part, rows, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x, dy and dx are
// contiguous (rows, d) in that dtype; gamma is contiguous float32 (d,);
// partials is contiguous float32 (2, nblocks, d): [0] the dgamma and [1]
// the dbeta partial sums of each block, every element written. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int dk_layernorm_bwd(const void* x, const void* dy,
                                const void* gamma, void* dx, void* partials,
                                long long rows, int d, float eps,
                                int nblocks, int dtype, void* stream) {
  if (rows < 1 || d < 1 || nblocks < 1 || nblocks > 65535)
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
