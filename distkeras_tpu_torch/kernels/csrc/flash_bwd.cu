// FlashAttention backward for Hopper (sm_90a), bound through a plain C
// interface: two kernels, dQ and dK/dV (the FlashAttention-2 split).
//
// Replaces: distkeras_tpu/ops/flash_attention.py `_dq_kernel` and
// `_dkv_kernel`, launched by `_bwd` through `pl.pallas_call` (the custom VJP
// behind `flash_attention`).
//
// Math (identical to the JAX kernels and to the port's plain version
// `_reference_flash_bwd`): with scale = 1/sqrt(D), per (batch, head),
//     s  = scale * q k^T,  p = exp(s - lse)  (masked: p = 0; lse = -inf
//                                              shifts by 0, as in JAX)
//     dp = dO v^T,         ds = p * (dp - delta) * scale
//     dQ = ds k,  dK = ds^T q,  dV = p^T dO,  delta = rowsum(dO * O)
// with f32 accumulation and outputs in the inputs' dtype. delta is folded
// into the dQ kernel (each query tile computes its rows' delta and writes
// it out); the dK/dV kernel, launched after it on the same stream, reads it.
//
// Layout: q, k, v, O, dO, dQ, dK, dV are contiguous (B, T, H, D), the
// framework layout, read with strides (no transposes); lse and delta are
// (B, H, T) f32.
//
// Bound on an H100: operations. Causal T = 512, D = 64 does 6*D FLOPs per
// visible (query, key) pair in the dQ kernel and 8*D in the dK/dV kernel,
// against a few bytes per pair of input; in f32 (no TF32) the peak is the
// CUDA cores' 67 TFLOP/s. The design keeps p and ds on chip as the TPU
// kernels do, and needs no atomics:
//   * dQ: one 256-thread block per (b, h, 64-row query tile); K/V stream
//     through shared memory in 64-row tiles up to the diagonal (causal);
//     four lanes share a query row (each owns a quarter of the keys of a
//     tile and a quarter of the dQ columns).
//   * dK/dV: one 256-thread block per (b, h, 64-row key tile); Q/dO/lse/
//     delta tiles stream from the diagonal on (causal); four lanes share a
//     key row (a quarter of the queries of a tile, a quarter of the
//     columns of dK and dV).
// Any T (the tail tile is masked), D <= 128. Shared rows are padded by one
// float so the strided reads are bank-conflict-free. Not yet done (later
// PRs): tensor cores (wgmma / mma.sync), TMA loads, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 4 threads per row
constexpr int kSub = 4;

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

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Load a (rows, DMAX) tile starting at time step t0 into shared memory with
// row stride LD, zero past t_len and past d.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long base, long long row_stride,
                                          int t0, int t_len, int d) {
  constexpr int LD = DMAX + 1;
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += kThreads) {
    const int rr = idx / DMAX, e = idx % DMAX;
    const int t = t0 + rr;
    float val = 0.f;
    if (t < t_len && e < d) val = to_f32(src[base + t * row_stride + e]);
    dst[rr * LD + e] = val;
  }
}

template <int DMAX>
constexpr int dq_smem_floats() {
  return 4 * 64 * (DMAX + 1) + kBQ * (kBK + 1);
}

template <int DMAX>
constexpr int dkv_smem_floats() {
  return 4 * 64 * (DMAX + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ;
}

// ------------------------------------------------------------------- dQ

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        int t_len, int heads, int d, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NS = kBK / kSub;   // keys per thread per tile
  constexpr int NC = DMAX / kSub;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;  // (kBQ, kBK + 1)

  const int tid = threadIdx.x;
  const int r = tid / kSub;
  const int sub = tid % kSub;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)heads * d;
  const long long base = (long long)b * t_len * row_stride + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * t_len;
  const int qpos = q0 + r;

  load_tile<T, DMAX>(sQ, q, base, row_stride, q0, t_len, d);
  load_tile<T, DMAX>(sdO, dout, base, row_stride, q0, t_len, d);
  __syncthreads();

  // delta = rowsum(dO * O) for this row; the 4 lanes of a row split it
  float part = 0.f;
  if (qpos < t_len) {
    const T* orow = o + base + qpos * row_stride;
    for (int c = sub; c < d; c += kSub) part += sdO[r * LD + c] * to_f32(orow[c]);
  }
  const float dlt = quad_sum(part);
  float shift = 0.f;
  if (qpos < t_len) {
    const float l = lse[stat + qpos];
    shift = l == -INFINITY ? 0.f : l;  // a row that attends nothing
    if (sub == 0) delta[stat + qpos] = dlt;
  }

  int nk = (t_len + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ + kBK - 1) / kBK);  // skip tiles above the diagonal

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // previous tile's sK/sV/sdS fully consumed
    load_tile<T, DMAX>(sK, k, base, row_stride, k0, t_len, d);
    load_tile<T, DMAX>(sV, v, base, row_stride, k0, t_len, d);
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int e = 0; e < DMAX; ++e) {
      const float qv = sQ[r * LD + e];
      const float dov = sdO[r * LD + e];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kr = (sub + kSub * i) * LD + e;
        s[i] += qv * sK[kr];
        dp[i] += dov * sV[kr];
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + sub + kSub * i;
      const bool ok = kpos < t_len && (!causal || kpos <= qpos);
      const float p = ok ? expf(scale * s[i] - shift) : 0.f;
      sdS[r * (kBK + 1) + sub + kSub * i] = p * (dp[i] - dlt) * scale;
    }
    __syncwarp();  // the row's 4 lanes share one warp
    for (int jj = 0; jj < kBK; ++jj) {
      const float ds = sdS[r * (kBK + 1) + jj];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] += ds * sK[jj * LD + sub + kSub * i];
    }
  }

  if (qpos < t_len) {
    T* row = dq + base + qpos * row_stride;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + kSub * i;
      if (c < d) row[c] = from_f32<T>(acc[i]);
    }
  }
}

// ----------------------------------------------------------------- dK/dV

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int t_len, int heads, int d,
                         float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NQ = kBQ / kSub;   // queries per thread per tile
  constexpr int NC = DMAX / kSub;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;        // (kBK, kBQ + 1)
  float* sdS = sP + kBK * (kBQ + 1);  // (kBK, kBQ + 1)
  float* sShift = sdS + kBK * (kBQ + 1);
  float* sDelta = sShift + kBQ;

  const int tid = threadIdx.x;
  const int r = tid / kSub;  // key row of the tile
  const int sub = tid % kSub;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)heads * d;
  const long long base = (long long)b * t_len * row_stride + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * t_len;
  const int kpos = k0 + r;

  load_tile<T, DMAX>(sK, k, base, row_stride, k0, t_len, d);
  load_tile<T, DMAX>(sV, v, base, row_stride, k0, t_len, d);

  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int nq = (t_len + kBQ - 1) / kBQ;
  // causal: query tiles that end before this key tile starts are fully
  // masked; start at the diagonal
  const int q_start = causal ? k0 / kBQ : 0;
  for (int it = q_start; it < nq; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();  // previous tile fully consumed (and sK/sV loaded)
    load_tile<T, DMAX>(sQ, q, base, row_stride, q0, t_len, d);
    load_tile<T, DMAX>(sdO, dout, base, row_stride, q0, t_len, d);
    if (tid < kBQ) {
      const int t = q0 + tid;
      float sh = 0.f, dl = 0.f;
      if (t < t_len) {
        const float l = lse[stat + t];
        sh = l == -INFINITY ? 0.f : l;
        dl = delta[stat + t];
      }
      sShift[tid] = sh;
      sDelta[tid] = dl;
    }
    __syncthreads();

    float s[NQ], dp[NQ];
#pragma unroll
    for (int m = 0; m < NQ; ++m) s[m] = dp[m] = 0.f;
#pragma unroll 4
    for (int e = 0; e < DMAX; ++e) {
      const float kv = sK[r * LD + e];
      const float vv = sV[r * LD + e];
#pragma unroll
      for (int m = 0; m < NQ; ++m) {
        const int qr = (sub + kSub * m) * LD + e;
        s[m] += sQ[qr] * kv;
        dp[m] += sdO[qr] * vv;
      }
    }
#pragma unroll
    for (int m = 0; m < NQ; ++m) {
      const int qq = sub + kSub * m;
      const int qpos = q0 + qq;
      const bool ok = qpos < t_len && kpos < t_len && (!causal || kpos <= qpos);
      const float p = ok ? expf(scale * s[m] - sShift[qq]) : 0.f;
      sP[r * (kBQ + 1) + qq] = p;
      sdS[r * (kBQ + 1) + qq] = p * (dp[m] - sDelta[qq]) * scale;
    }
    __syncwarp();  // the row's 4 lanes share one warp
    for (int qq = 0; qq < kBQ; ++qq) {
      const float p = sP[r * (kBQ + 1) + qq];
      const float ds = sdS[r * (kBQ + 1) + qq];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + kSub * i;
        acc_v[i] += p * sdO[qq * LD + c];
        acc_k[i] += ds * sQ[qq * LD + c];
      }
    }
  }

  if (kpos < t_len) {
    T* krow = dk + base + kpos * row_stride;
    T* vrow = dv + base + kpos * row_stride;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + kSub * i;
      if (c < d) {
        krow[c] = from_f32<T>(acc_k[i]);
        vrow[c] = from_f32<T>(acc_v[i]);
      }
    }
  }
}

// above 48 KB of dynamic shared memory a kernel must opt in; once per
// instantiation (the attribute is per function, and a launch inside a
// CUDA-graph capture must not repeat the call)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              int batch, int t_len, int heads, int d, float scale, int causal,
              cudaStream_t stream) {
  const int bytes = dq_smem_floats<DMAX>() * (int)sizeof(float);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DMAX>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, heads, batch);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), t_len, heads, d, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int batch, int t_len, int heads, int d, float scale, int causal,
               cudaStream_t stream) {
  const int bytes = dkv_smem_floats<DMAX>() * (int)sizeof(float);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, DMAX>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBK - 1) / kBK, heads, batch);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, heads, d, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                int batch, int t_len, int heads, int d, float scale, int causal,
                cudaStream_t s) {
  if (d <= 32) return launch_dq<T, 32>(q, k, v, o, dout, lse, delta, dq, batch, t_len, heads, d, scale, causal, s);
  if (d <= 64) return launch_dq<T, 64>(q, k, v, o, dout, lse, delta, dq, batch, t_len, heads, d, scale, causal, s);
  return launch_dq<T, 128>(q, k, v, o, dout, lse, delta, dq, batch, t_len, heads, d, scale, causal, s);
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int batch, int t_len, int heads, int d,
                 float scale, int causal, cudaStream_t s) {
  if (d <= 32) return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, batch, t_len, heads, d, scale, causal, s);
  if (d <= 64) return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, batch, t_len, heads, d, scale, causal, s);
  return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, batch, t_len, heads, d, scale, causal, s);
}

bool bad_shape(int batch, int t_len, int heads, int d) {
  return batch < 0 || t_len < 0 || heads < 0 || d < 1 || d > 128 ||
         heads > 65535 || batch > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v, o, dout, dq are
// contiguous (batch, t_len, heads, d) with d <= 128; lse (read) and delta
// (written) are contiguous f32 (batch, heads, t_len). Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int dk_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               int batch, int t_len, int heads, int d,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (bad_shape(batch, t_len, heads, d)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || t_len == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dq<float>(q, k, v, o, dout, lse, delta, dq, batch, t_len, heads, d, scale, causal, s);
    case 1: return dispatch_dq<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, batch, t_len, heads, d, scale, causal, s);
    case 2: return dispatch_dq<__half>(q, k, v, o, dout, lse, delta, dq, batch, t_len, heads, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Same layouts; reads the delta that dk_flash_bwd_dq wrote (launch it
// first, on the same stream); writes dk and dv.
extern "C" int dk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int batch, int t_len, int heads, int d,
                                float scale, int causal, int dtype,
                                void* stream) {
  if (bad_shape(batch, t_len, heads, d)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || t_len == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, batch, t_len, heads, d, scale, causal, s);
    case 1: return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, batch, t_len, heads, d, scale, causal, s);
    case 2: return dispatch_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, batch, t_len, heads, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
