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
// Bound on an H100: bytes at the training step's (4096, 512), where the row
// is read once and written once and the arithmetic is a handful of FLOPs
// per element; latency at the decode and prefill shapes ((8, 512): 16 KB
// in, 16 KB out), where one launch and its memory round trips are the
// whole cost. The design cuts both to one trip per row:
//   * D <= 1024: one warp per row, 4 rows per 128-thread block, and the row
//     stays in registers between the two reductions. A lane starts all its
//     loads at once, before the first reduction: its 16-byte chunks of x
//     (float4 in f32, 8 halves in bf16/f16), and the gamma and beta
//     columns of those chunks (f32, float4). Chunk c of a row goes to lane
//     c % 32, so each load instruction of the warp covers 512 contiguous
//     bytes. Then the mean and the centred second moment are two
//     warp-shuffle reductions, and y leaves in 16-byte stores. Where a row
//     is not a whole number of 16-byte chunks or a pointer is not 16-byte
//     aligned (D = 510, a view with a storage offset), the same kernel is
//     instantiated with one-element chunks: the scalar path, with the same
//     single batch of loads.
//   * D > 1024: one 256-thread block per row, block reductions through
//     shared memory; the row is read from device memory once and kept, as
//     f32, in dynamic shared memory (each thread reads back only the chunks
//     it wrote). A row too long for shared memory (D > kMaxStagedD) is read
//     again from L2 for the second and third pass.
// The TPU gates (D % 128 == 0, rows >= 8) were lane-tiling artifacts and
// are gone: any D, any row count.

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

// E consecutive elements (one 16-byte load when E * sizeof(T) == 16)
template <typename T, int E>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           float (&v)[E]) {
  if constexpr (E * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = to_f32(p[i]);
  }
}

// E consecutive f32 (float4 loads when E is a multiple of 4)
template <int E>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = p[i];
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            const float (&v)[E]) {
  if constexpr (E * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) p[i] = from_f32<T>(v[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kRowsPerBlock = 4;    // warps (rows) per block, warp kernel
constexpr int kBlockThreads = 256;  // threads per row, block kernel
// longest row the block kernel keeps in shared memory (f32): 192 KB
constexpr int kMaxStagedD = 48 * 1024;

// One warp per row. Chunks of E elements (E = 16 / sizeof(T): the vector
// path; E = 1: the scalar path); lane l holds chunks l, l + 32, ..., at
// most NC of them, so NC * 32 * E >= D.
template <typename T, int E, int NC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_fwd_warp(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y,
                long long rows, int d, float eps) {
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;  // whole warp exits together
  const int nch = d / E;    // E divides d on both paths
  const T* xr = x + row * d;
  // one batch of loads: x, gamma, beta of every chunk this lane holds
  float v[NC][E], g[NC][E], b[NC][E];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      load_chunk<T, E>(xr + c * E, v[i]);
      load_f32<E>(gamma + c * E, g[i]);
      load_f32<E>(beta + c * E, b[i]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (lane + 32 * i < nch)
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[i][e];
  const float inv_d = 1.f / (float)d;
  const float mean = warp_sum(s) * inv_d;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (lane + 32 * i < nch)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = v[i][e] - mean;
        ss += t * t;
      }
  const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < nch) {
      float out[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        out[e] = (v[i][e] - mean) * rstd * g[i][e] + b[i][e];
      store_chunk<T, E>(yr + c * E, out);
    }
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

// One block per row, for D > 1024, chunks of E elements as in the warp
// kernel. staged: the row is kept in shared memory (d floats of dynamic
// shared memory), else it is read again from device memory.
template <typename T, int E>
__global__ void __launch_bounds__(kBlockThreads)
    ln_fwd_block(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ y, int d,
                 float eps, int staged) {
  __shared__ float red[32];
  extern __shared__ __align__(16) float srow[];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const int nch = d / E;
  const float inv_d = 1.f / (float)d;
  float v[E];
  float s = 0.f;
  for (int c = threadIdx.x; c < nch; c += blockDim.x) {
    load_chunk<T, E>(xr + c * E, v);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s += v[e];
      if (staged) srow[c * E + e] = v[e];
    }
  }
  const float mean = block_sum(s, red) * inv_d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < nch; c += blockDim.x) {
    if (staged) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = srow[c * E + e];
    } else {
      load_chunk<T, E>(xr + c * E, v);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float t = v[e] - mean;
      ss += t * t;
    }
  }
  const float rstd = rsqrtf(block_sum(ss, red) * inv_d + eps);
  T* yr = y + row * d;
  for (int c = threadIdx.x; c < nch; c += blockDim.x) {
    float g[E], b[E], out[E];
    if (staged) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = srow[c * E + e];
    } else {
      load_chunk<T, E>(xr + c * E, v);
    }
    load_f32<E>(gamma + c * E, g);
    load_f32<E>(beta + c * E, b);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = (v[e] - mean) * rstd * g[e] + b[e];
    store_chunk<T, E>(yr + c * E, out);
  }
}

template <typename T, int E, int NC>
void launch_warp(const void* x, const float* g, const float* b, void* y,
                 long long rows, int d, float eps, cudaStream_t stream) {
  const dim3 block(32, kRowsPerBlock);
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_warp<T, E, NC><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), rows, d, eps);
}

// the block kernel's shared-memory opt-in above 48 KB, once per
// instantiation (a launch inside a CUDA-graph capture must not repeat it)
template <typename T, int E>
int launch_block(const void* x, const float* g, const float* b, void* y,
                 long long rows, int d, float eps, cudaStream_t stream) {
  static bool configured = false;
  const int staged = d <= kMaxStagedD;
  const int bytes = staged ? d * (int)sizeof(float) : 0;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_fwd_block<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxStagedD * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  ln_fwd_block<T, E><<<(unsigned)rows, kBlockThreads, bytes, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), d, eps, staged);
  return 0;
}

// the warp kernel for chunks of E at D <= 1024: NC chunks per lane,
// rounded up to a power of two (at most 1024 / (32 E), so only the
// instantiations a row can need are built)
template <typename T, int E, int NC = 1>
void launch_rows(const void* x, const float* g, const float* b, void* y,
                 long long rows, int d, float eps, cudaStream_t s) {
  if constexpr (NC < 1024 / (32 * E)) {
    if ((d / E + 31) / 32 > NC)
      return launch_rows<T, E, 2 * NC>(x, g, b, y, rows, d, eps, s);
  }
  launch_warp<T, E, NC>(x, g, b, y, rows, d, eps, s);
}

template <typename T>
int launch(const void* x, const float* g, const float* b, void* y,
           long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (d > 1024)
    return vec ? launch_block<T, kVec>(x, g, b, y, rows, d, eps, stream)
               : launch_block<T, 1>(x, g, b, y, rows, d, eps, stream);
  if (vec)
    launch_rows<T, kVec>(x, g, b, y, rows, d, eps, stream);
  else
    launch_rows<T, 1>(x, g, b, y, rows, d, eps, stream);
  return 0;
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
  int err = 0;
  switch (dtype) {
    case 0: err = launch<float>(x, g, b, y, rows, d, eps, s); break;
    case 1: err = launch<__nv_bfloat16>(x, g, b, y, rows, d, eps, s); break;
    case 2: err = launch<__half>(x, g, b, y, rows, d, eps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
