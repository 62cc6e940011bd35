// LayerNorm forward for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces: distkeras_tpu/ops/fused_layernorm.py `_fwd_kernel`, launched by
// `_fwd` through `pl.pallas_call` (the one-pass TPU kernel behind
// `fused_layer_norm`).
//
// Math (identical to the JAX kernel and to the port's plain version
// `_reference_layer_norm`): per row of x (rows, D), f32 compute,
//     mean = sum(x) / D,  var = sum((x - mean)^2) / D   (biased),
//     y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// written in the dtype of x (f32, bf16 or f16); gamma and beta are f32.
//
// Bound on an H100: bytes. The row is read once and written once; the
// arithmetic is a handful of FLOPs per element, far below the ~20 FLOP per
// byte an f32 pass would need to stop being memory-bound. The design keeps
// the row in registers between the two reductions, so x leaves device
// memory exactly once (the TPU kernel's point, kept):
//   * D <= 1024: one warp per row, 4 rows per 128-thread block. Lane l holds
//     columns l, l+32, ... (coalesced loads across the warp); the mean and
//     the centred second moment are two warp-shuffle reductions.
//   * D > 1024: one 256-thread block per row, block reductions through
//     shared memory; the row is re-read from device memory (L2-resident).
// The TPU gates (D % 128 == 0, rows >= 8) were lane-tiling artifacts and
// are gone: any D, any row count. Not yet done (a later PR): 16-byte
// vector loads and several rows per warp for small D.

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

constexpr int kRowsPerBlock = 4;  // warps (rows) per block, warp kernel
constexpr int kBlockThreads = 256;  // threads per row, block kernel

// One warp per row; NPL values per lane cover D <= 32 * NPL.
template <typename T, int NPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_fwd_warp(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y,
                long long rows, int d, float eps) {
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;  // whole warp exits together
  const T* xr = x + row * d;
  float v[NPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float inv_d = 1.f / (float)d;
  const float mean = warp_sum(s) * inv_d;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    const float t = c < d ? v[i] - mean : 0.f;
    ss += t * t;
  }
  const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < d) yr[c] = from_f32<T>((v[i] - mean) * rstd * gamma[c] + beta[c]);
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

// One block per row, for D > 1024.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    ln_fwd_block(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ y, int d,
                 float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const float inv_d = 1.f / (float)d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) s += to_f32(xr[c]);
  const float mean = block_sum(s, red) * inv_d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float t = to_f32(xr[c]) - mean;
    ss += t * t;
  }
  const float rstd = rsqrtf(block_sum(ss, red) * inv_d + eps);
  T* yr = y + row * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    yr[c] = from_f32<T>((to_f32(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
}

template <typename T, int NPL>
void launch_warp(const void* x, const float* g, const float* b, void* y,
                 long long rows, int d, float eps, cudaStream_t stream) {
  const dim3 block(32, kRowsPerBlock);
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_warp<T, NPL><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), rows, d, eps);
}

template <typename T>
void launch(const void* x, const float* g, const float* b, void* y,
            long long rows, int d, float eps, cudaStream_t stream) {
  const int npl = (d + 31) / 32;
  if (npl <= 1) return launch_warp<T, 1>(x, g, b, y, rows, d, eps, stream);
  if (npl <= 2) return launch_warp<T, 2>(x, g, b, y, rows, d, eps, stream);
  if (npl <= 4) return launch_warp<T, 4>(x, g, b, y, rows, d, eps, stream);
  if (npl <= 8) return launch_warp<T, 8>(x, g, b, y, rows, d, eps, stream);
  if (npl <= 16) return launch_warp<T, 16>(x, g, b, y, rows, d, eps, stream);
  if (npl <= 32) return launch_warp<T, 32>(x, g, b, y, rows, d, eps, stream);
  ln_fwd_block<T><<<(unsigned)rows, kBlockThreads, 0, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x and y are contiguous
// (rows, d); gamma and beta are contiguous float32 (d,). Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int dk_layernorm_fwd(const void* x, const void* gamma,
                                const void* beta, void* y, long long rows,
                                int d, float eps, int dtype, void* stream) {
  if (rows < 0 || d < 1 || rows > 0x7fffffffLL * kRowsPerBlock)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  switch (dtype) {
    case 0: launch<float>(x, g, b, y, rows, d, eps, s); break;
    case 1: launch<__nv_bfloat16>(x, g, b, y, rows, d, eps, s); break;
    case 2: launch<__half>(x, g, b, y, rows, d, eps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
