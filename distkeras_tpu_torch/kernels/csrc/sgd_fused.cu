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
// Bound on an H100: bytes. 12 bytes per f32 parameter for SGD (p, g read, p
// written) and 20 with momentum (m read and written too), against 2-4
// FLOPs. The design is adam_fused.cu's: ONE launch per step over all leaves
// (the TPU path launched one pallas_call per leaf); the caller builds, once
// per set of parameters, a device table of leaves ([p, n] or [p, m, n]) and
// of 4096-element chunks (leaf, start); the blocks walk the chunks with a
// grid stride, each thread on 16-byte float4 loads where the buffers are
// aligned, scalar loads otherwise. The gradients' pointers sit in a table
// of their own, uploaded again only when autograd moves them. The JAX
// package's small-leaf cutoff (`_MIN_KERNEL_SIZE`, a TPU launch-cost
// choice) is gone: the math is identical, so every leaf takes the kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// leaves: (L, 2) int64 [p, n]; grads: (L,) int64 g pointers; chunks:
// (C, 2) int64 [leaf, start].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgd_fused_kernel(const long long* __restrict__ leaves,
                     const long long* __restrict__ grads,
                     const long long* __restrict__ chunks, int n_chunks,
                     int chunk, float lr) {
  for (int ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    const long long li = chunks[2 * ci];
    const long long* leaf = leaves + 2 * li;
    const long long start = chunks[2 * ci + 1];
    T* p = reinterpret_cast<T*>(leaf[0]) + start;
    const T* g = reinterpret_cast<const T*>(grads[li]) + start;
    const int len = (int)min((long long)chunk, leaf[1] - start);
    int head = 0;  // elements done by the vector loop
    if constexpr (sizeof(T) == 4) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(g);
      if ((a & 15) == 0) {
        head = len & ~3;
        for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads) {
          float4 pv = *reinterpret_cast<const float4*>(p + i);
          const float4 gv = *reinterpret_cast<const float4*>(g + i);
          pv.x = sgd(pv.x, gv.x, lr);
          pv.y = sgd(pv.y, gv.y, lr);
          pv.z = sgd(pv.z, gv.z, lr);
          pv.w = sgd(pv.w, gv.w, lr);
          *reinterpret_cast<float4*>(p + i) = pv;
        }
      }
    }
    for (int i = head + threadIdx.x; i < len; i += kThreads) {
      p[i] = from_f32<T>(sgd(to_f32(p[i]), to_f32(g[i]), lr));
    }
  }
}

// leaves: (L, 3) int64 [p, m, n]; grads and chunks as above.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgd_momentum_fused_kernel(const long long* __restrict__ leaves,
                              const long long* __restrict__ grads,
                              const long long* __restrict__ chunks,
                              int n_chunks, int chunk, float lr, float mu,
                              int nesterov) {
  const bool nest = nesterov != 0;
  for (int ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    const long long li = chunks[2 * ci];
    const long long* leaf = leaves + 3 * li;
    const long long start = chunks[2 * ci + 1];
    T* p = reinterpret_cast<T*>(leaf[0]) + start;
    float* m = reinterpret_cast<float*>(leaf[1]) + start;
    const T* g = reinterpret_cast<const T*>(grads[li]) + start;
    const int len = (int)min((long long)chunk, leaf[2] - start);
    int head = 0;
    if constexpr (sizeof(T) == 4) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m);
      if ((a & 15) == 0) {
        head = len & ~3;
        for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads) {
          float4 pv = *reinterpret_cast<const float4*>(p + i);
          const float4 gv = *reinterpret_cast<const float4*>(g + i);
          float4 mv = *reinterpret_cast<const float4*>(m + i);
          pv.x = sgd_momentum(pv.x, gv.x, mv.x, lr, mu, nest);
          pv.y = sgd_momentum(pv.y, gv.y, mv.y, lr, mu, nest);
          pv.z = sgd_momentum(pv.z, gv.z, mv.z, lr, mu, nest);
          pv.w = sgd_momentum(pv.w, gv.w, mv.w, lr, mu, nest);
          *reinterpret_cast<float4*>(p + i) = pv;
          *reinterpret_cast<float4*>(m + i) = mv;
        }
      }
    }
    for (int i = head + threadIdx.x; i < len; i += kThreads) {
      float mi = m[i];
      const float pn =
          sgd_momentum(to_f32(p[i]), to_f32(g[i]), mi, lr, mu, nest);
      p[i] = from_f32<T>(pn);
      m[i] = mi;
    }
  }
}

bool bad_grid(int n_chunks, int chunk, int grid) {
  return n_chunks < 1 || chunk < 4 || (chunk & 3) || grid < 1 ||
         grid > n_chunks;
}

}  // namespace

// dtype (of every p and g): 0 = float32, 1 = bfloat16, 2 = float16. leaves
// is a device int64 (L, 2) table [p, n] (every buffer contiguous); grads a
// device int64 (L,) table of the gradients' pointers (g of leaf l has n
// elements); chunks a device int64 (n_chunks, 2) table [leaf, start]
// cutting each leaf into pieces of at most `chunk` elements, chunk a
// multiple of 4. Returns the CUDA error code of the launch (0 = launched).
extern "C" int dk_sgd_fused(const void* leaves, const void* grads,
                            const void* chunks, int n_chunks, int chunk,
                            int grid, float lr, int dtype, void* stream) {
  if (bad_grid(n_chunks, chunk, grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lv = static_cast<const long long*>(leaves);
  const auto* gp = static_cast<const long long*>(grads);
  const auto* ck = static_cast<const long long*>(chunks);
  switch (dtype) {
    case 0:
      sgd_fused_kernel<float><<<grid, kThreads, 0, s>>>(lv, gp, ck, n_chunks,
                                                        chunk, lr);
      break;
    case 1:
      sgd_fused_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          lv, gp, ck, n_chunks, chunk, lr);
      break;
    case 2:
      sgd_fused_kernel<__half><<<grid, kThreads, 0, s>>>(lv, gp, ck, n_chunks,
                                                         chunk, lr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As dk_sgd_fused, with leaves a device int64 (L, 3) table [p, m, n] (m
// float32, contiguous, updated in place); nesterov 0 or 1.
extern "C" int dk_sgd_momentum_fused(const void* leaves, const void* grads,
                                     const void* chunks, int n_chunks,
                                     int chunk, int grid, float lr, float mu,
                                     int nesterov, int dtype, void* stream) {
  if (bad_grid(n_chunks, chunk, grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lv = static_cast<const long long*>(leaves);
  const auto* gp = static_cast<const long long*>(grads);
  const auto* ck = static_cast<const long long*>(chunks);
  switch (dtype) {
    case 0:
      sgd_momentum_fused_kernel<float><<<grid, kThreads, 0, s>>>(
          lv, gp, ck, n_chunks, chunk, lr, mu, nesterov);
      break;
    case 1:
      sgd_momentum_fused_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          lv, gp, ck, n_chunks, chunk, lr, mu, nesterov);
      break;
    case 2:
      sgd_momentum_fused_kernel<__half><<<grid, kThreads, 0, s>>>(
          lv, gp, ck, n_chunks, chunk, lr, mu, nesterov);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
