// Fused multi-tensor Adam for Hopper (sm_90a), bound through a plain C
// interface: one launch updates every parameter leaf of a model.
//
// Replaces: distkeras_tpu/ops/pallas_kernels.py `_adam_kernel` (math
// `_adam_math`), launched per leaf by `_leaf_adam` through `pl.pallas_call`
// from `FusedAdam.fused_apply` (optimizer "pallas_adam").
//
// Math (identical to the JAX kernel and to the port's plain version
// `_adam_math`), per element in f32, in the same operation order, each
// step rounded (the __f*_rn intrinsics are never contracted into FMAs):
//     m' = b1*m + (1-b1)*g
//     v' = b2*v + (1-b2)*g*g
//     p' = p - lr*(m'*c1) / (sqrt(v'*c2) + eps)
// with c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t), t = float(count + 1), as
// `FusedAdam.fused_apply` computes them (pallas_kernels.py:275-277). The
// count lives on the device: every block reads it, and the last block to
// finish (a counter of arrived blocks beside it) increments it and resets
// the counter — so there is no host sync and the launch is CUDA-graph-safe.
// p is written in its own dtype (f32, bf16 or f16; g shares it), m and v
// stay f32. IEEE sqrt and division (no fast math).
//
// Bound on an H100: bytes. 28 bytes per f32 parameter (p, m, v read and
// written, g read) against ~15 FLOPs. The design makes ONE launch per step
// over all leaves (the TPU path launched one pallas_call per leaf): the
// caller builds, once per set of parameters, a device table of leaves (p,
// m, v pointers and length) and of 4096-element chunks (leaf, start); the
// blocks walk the chunks with a grid stride, each thread on 16-byte float4
// loads where the four buffers are aligned, scalar loads otherwise. The
// gradients' pointers sit in a table of their own, because autograd hands
// out new gradient buffers each step: only those 8 bytes per leaf are
// uploaded again (asynchronously) when they move. The JAX package's
// small-leaf cutoff (`_MIN_KERNEL_SIZE`, a TPU launch-cost choice) is gone:
// the math is identical, so every leaf takes the kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, c1, c2;
};

__device__ __forceinline__ float adam(float p, float g, float& m, float& v,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float num = __fmul_rn(h.lr, __fmul_rn(m, h.c1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.c2)), h.eps);
  return __fsub_rn(p, __fdiv_rn(num, den));
}

// leaves: (L, 4) int64 [p, m, v, n]; grads: (L,) int64 g pointers;
// chunks: (C, 2) int64 [leaf, start]; step: int32 [count, arrived blocks].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adam_fused_kernel(const long long* __restrict__ leaves,
                      const long long* __restrict__ grads,
                      const long long* __restrict__ chunks, int n_chunks,
                      int chunk, float lr, float b1, float omb1, float b2,
                      float omb2, float eps, int* step) {
  __shared__ float sc[2];
  if (threadIdx.x == 0) {
    const float t = (float)(*(volatile int*)step + 1);
    sc[0] = 1.f / (1.f - powf(b1, t));
    sc[1] = 1.f / (1.f - powf(b2, t));
  }
  __syncthreads();
  const Hyper h{lr, b1, omb1, b2, omb2, eps, sc[0], sc[1]};

  for (int ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    const long long li = chunks[2 * ci];
    const long long* leaf = leaves + 4 * li;
    const long long start = chunks[2 * ci + 1];
    T* p = reinterpret_cast<T*>(leaf[0]) + start;
    const T* g = reinterpret_cast<const T*>(grads[li]) + start;
    float* m = reinterpret_cast<float*>(leaf[1]) + start;
    float* v = reinterpret_cast<float*>(leaf[2]) + start;
    const int len = (int)min((long long)chunk, leaf[3] - start);
    int head = 0;  // elements done by the vector loop
    if constexpr (sizeof(T) == 4) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m) |
                          reinterpret_cast<uintptr_t>(v);
      if ((a & 15) == 0) {
        head = len & ~3;
        for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads) {
          float4 pv = *reinterpret_cast<const float4*>(p + i);
          const float4 gv = *reinterpret_cast<const float4*>(g + i);
          float4 mv = *reinterpret_cast<const float4*>(m + i);
          float4 vv = *reinterpret_cast<const float4*>(v + i);
          pv.x = adam(pv.x, gv.x, mv.x, vv.x, h);
          pv.y = adam(pv.y, gv.y, mv.y, vv.y, h);
          pv.z = adam(pv.z, gv.z, mv.z, vv.z, h);
          pv.w = adam(pv.w, gv.w, mv.w, vv.w, h);
          *reinterpret_cast<float4*>(p + i) = pv;
          *reinterpret_cast<float4*>(m + i) = mv;
          *reinterpret_cast<float4*>(v + i) = vv;
        }
      }
    }
    for (int i = head + threadIdx.x; i < len; i += kThreads) {
      float mi = m[i], vi = v[i];
      const float pn = adam(to_f32(p[i]), to_f32(g[i]), mi, vi, h);
      p[i] = from_f32<T>(pn);
      m[i] = mi;
      v[i] = vi;
    }
  }

  // the last block to arrive advances the count (every block has read it
  // by now) and resets the arrival counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(step + 1, 1) == (int)gridDim.x - 1) {
      step[0] += 1;
      step[1] = 0;
      __threadfence();
    }
  }
}

template <typename T>
int launch(const void* leaves, const void* grads, const void* chunks,
           int n_chunks, int chunk, int grid, float lr, float b1, float omb1,
           float b2, float omb2, float eps, void* step, cudaStream_t stream) {
  adam_fused_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const long long*>(leaves),
      static_cast<const long long*>(grads),
      static_cast<const long long*>(chunks), n_chunks, chunk, lr, b1, omb1,
      b2, omb2, eps, static_cast<int*>(step));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of every p and g): 0 = float32, 1 = bfloat16, 2 = float16. leaves
// is a device int64 (L, 4) table [p, m, v, n] (m and v float32, every
// buffer contiguous); grads a device int64 (L,) table of the gradients'
// pointers (g of leaf l has n elements); chunks a device int64 (n_chunks,
// 2) table [leaf, start] cutting each leaf into pieces of at most `chunk`
// elements, chunk a multiple of 4; step a device int32 [count, 0]. omb1 = 1 - b1 and omb2 =
// 1 - b2 are rounded to float from the caller's doubles, as the JAX kernel
// sees them. Returns the CUDA error code of the launch (0 = launched).
extern "C" int dk_adam_fused(const void* leaves, const void* grads,
                             const void* chunks, int n_chunks, int chunk,
                             int grid, float lr,
                             float b1, float omb1, float b2, float omb2,
                             float eps, void* step, int dtype, void* stream) {
  if (n_chunks < 1 || chunk < 4 || (chunk & 3) || grid < 1 ||
      grid > n_chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(leaves, grads, chunks, n_chunks, chunk, grid, lr, b1, omb1, b2, omb2, eps, step, s);
    case 1: return launch<__nv_bfloat16>(leaves, grads, chunks, n_chunks, chunk, grid, lr, b1, omb1, b2, omb2, eps, step, s);
    case 2: return launch<__half>(leaves, grads, chunks, n_chunks, chunk, grid, lr, b1, omb1, b2, omb2, eps, step, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
