// FlashAttention forward for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces: distkeras_tpu/ops/flash_attention.py `_fwd_kernel`, launched by
// `_fwd` through `pl.pallas_call` (the forward behind `flash_attention`).
//
// Math (identical to the JAX kernel): per (batch, head, query row),
// online-softmax attention over K/V tiles with scale 1/sqrt(D), an optional
// causal mask (key position <= query position), f32 accumulation, and the
// row statistics
//     O   = softmax(q k^T * scale) v            (in the dtype of q)
//     lse = logsumexp(q k^T * scale)             (f32; -inf for a row that
//                                                  attends nothing)
// A fully-masked tile or row keeps m = -inf: the shift is guarded to 0 so
// exp(-inf - -inf) never appears, and l == 0 divides by 1 (the guards of
// flash_attention.py:80-84,102-104).
//
// Layout: q, k, v, O are contiguous (B, T, H, D), the framework layout, read
// with strides directly (no transposes); lse is (B, H, T) f32.
//
// Bound on an H100: operations. Causal attention at T = 512, D = 64 does
// ~4*D FLOPs per visible (query, key) pair against ~16*D bytes per row of
// input, so it is compute-bound; in f32 (no TF32: the port keeps full f32
// precision) the peak is the CUDA cores' 67 TFLOP/s. The design keeps the
// score matrix on chip, as the TPU kernel does: one 256-thread block per
// (b, h, 64-row query tile); K/V stream through shared memory in 64-row
// tiles; four threads share a query row (each owns a quarter of the scores
// of a tile and a quarter of the output columns); causal tiles entirely
// above the diagonal are never loaded; a tail tile past T is masked. Shared
// rows are padded by one float so the strided reads are bank-conflict-free.
// Not yet done (later PRs): tensor cores (wgmma / mma.sync), TMA loads and
// warp specialisation.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 256;  // 4 threads per query row
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

// reductions over the 4 adjacent lanes that share a query row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DMAX>
constexpr int smem_floats() {
  return 3 * kBQ * (DMAX + 1) + kBQ * (kBK + 1);
}

// DMAX: compile-time head-dim capacity (32, 64 or 128); d <= DMAX at run
// time, columns past d are zero in shared memory and never written out.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t_len, int heads, int d,
                     float scale, int causal) {
  constexpr int LD = DMAX + 1;  // padded shared row
  constexpr int NS = kBK / kSub;  // scores per thread per tile
  constexpr int NC = DMAX / kSub;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;  // (kBQ, kBK + 1)

  const int tid = threadIdx.x;
  const int r = tid / kSub;
  const int sub = tid % kSub;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)heads * d;  // one time step
  const long long base = (long long)b * t_len * row_stride + (long long)h * d;

  // Q tile, pre-scaled (as the TPU kernel does), zero past T and past d
  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int rr = idx / DMAX, e = idx % DMAX;
    const int t = q0 + rr;
    float val = 0.f;
    if (t < t_len && e < d) val = to_f32(q[base + t * row_stride + e]) * scale;
    sQ[rr * LD + e] = val;
  }

  const int qpos = q0 + r;
  int nk = (t_len + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ + kBK - 1) / kBK);  // skip tiles above the diagonal

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // previous tile's sK/sV/sP fully consumed
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int rr = idx / DMAX, e = idx % DMAX;
      const int t = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (t < t_len && e < d) {
        const long long off = base + t * row_stride + e;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      sK[rr * LD + e] = kv;
      sV[rr * LD + e] = vv;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int e = 0; e < DMAX; ++e) {
      const float qv = sQ[r * LD + e];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] += qv * sK[(sub + kSub * i) * LD + e];
    }
    float m_blk = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + sub + kSub * i;
      const bool ok = kpos < t_len && (!causal || kpos <= qpos);
      s[i] = ok ? s[i] : -INFINITY;
      m_blk = fmaxf(m_blk, s[i]);
    }
    m_blk = quad_max(m_blk);
    const float m_new = fmaxf(m, m_blk);
    // a row with nothing visible yet keeps m == -inf: guard the shift
    const float shift = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf((m == -INFINITY ? shift : m) - shift);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = expf(s[i] - shift);  // masked: exp(-inf) = 0
      sP[r * (kBK + 1) + sub + kSub * i] = p;
      rs += p;
    }
    l = l * corr + quad_sum(rs);
    m = m_new;
    __syncwarp();  // the row's 4 lanes share one warp
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= corr;
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = sP[r * (kBK + 1) + jj];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] += p * sV[jj * LD + sub + kSub * i];
    }
  }

  if (qpos < t_len) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    T* orow = o + base + qpos * row_stride;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + kSub * i;
      if (c < d) orow[c] = from_f32<T>(acc[i] * inv);
    }
    if (sub == 0) {
      lse[((long long)b * heads + h) * t_len + qpos] =
          m == -INFINITY ? -INFINITY : m + logf(l_safe);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int t_len, int heads, int d, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  // above 48 KB of dynamic shared memory a kernel must opt in; once per
  // instantiation (the attribute is per function, and a launch inside a
  // CUDA-graph capture must not repeat the call)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((t_len + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t_len, heads, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int t_len, int heads, int d, float scale,
               int causal, cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
  return launch<T, 128>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v, o contiguous
// (batch, t_len, heads, d) with d <= 128; lse contiguous f32 (batch, heads,
// t_len). Returns the CUDA error code of the launch (0 = launched).
extern "C" int dk_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int batch, int t_len,
                            int heads, int d, float scale, int causal,
                            int dtype, void* stream) {
  if (batch < 0 || t_len < 0 || heads < 0 || d < 1 || d > 128 ||
      heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || t_len == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
    case 2: return dispatch_d<__half>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
