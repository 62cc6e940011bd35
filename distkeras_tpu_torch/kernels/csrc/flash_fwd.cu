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
// 4*D FLOPs per visible (query, key) pair (S = Q K^T and O += P V) against
// a few bytes per pair. Both products run on the tensor cores through
// `mma.sync`, with the fragment helpers of flash_common.cuh (shared with
// the backward, flash_bwd.cu):
//   * f32 inputs: m16n8k8 TF32 with the 3xTF32 split (lo.hi + hi.lo +
//     hi.hi, f32 accumulate; lo.lo dropped), which keeps the error at f32
//     level. The bound is 3x the FLOPs at the 495 TFLOP/s TF32 peak.
//   * bf16/f16 inputs: m16n8k16 in one pass; the scores are scaled in f32
//     after the product, and P is rounded to the input type before P V.
//   * A non-finite f32 input: the split of an infinite element has lo =
//     tf32(inf - inf) (the card's canonical NaN, which tf32 rounding turns
//     into -0), so a cross term inf * lo can make a score NaN where the f32
//     product is +-inf. The K loop therefore runs as a pass (`fwd_pass`)
//     that reports a non-finite row sum or accumulator; a block where any
//     warp reports one restarts the K/V stream and runs the pass again with
//     the guarded split of flash_common.cuh (`Split<N, true>`: only hi.hi
//     sees the infinity), which gives the exact f32 product, so a row whose
//     every score is -inf keeps O = 0 and lse = -inf as in JAX. Finite
//     inputs never take the second pass and keep their bits; 16-bit
//     products are exact and take none.
//
// Design:
//   * One 128-thread block (four warps, 16 query rows each) per (b, h,
//     64-row query tile). S (16 x 64 per warp) lives in mma accumulators;
//     the online softmax runs on that layout (a row's 64 scores are spread
//     over the 4 lanes of a quad: max and sum reduce with __shfl_xor 1 and
//     2, and each lane keeps its own partial row sum until the end). P
//     feeds O += P V straight from the accumulators as the A operand (the
//     k-permuted TF32 fragment of `a_from_acc`): nothing of S or P goes
//     through shared memory.
//   * Q is used against every K tile, so it is loaded once: pre-scaled by
//     1/sqrt(D) in f32 (as the TPU kernel does), its A fragments split
//     (hi, lo) once and held in registers for the whole K loop — a third of
//     the split's integer work taken out of the loop. f32 at D = 128 would
//     need 128 registers for them, so there Q stays in shared memory and
//     is split per tile.
//   * K/V tiles are double-buffered with 16-byte `cp.async.cg` (rows past
//     T zero-filled): tile j+1 loads while tile j computes, one
//     __syncthreads per tile. Shared rows are padded by 16 bytes, which
//     keeps `ldmatrix` and the 32-bit B loads free of bank conflicts. A
//     head dim whose rows are not 16-byte multiples (or an unaligned
//     pointer) takes plain element loads into the same buffers.
//   * Shared memory: Q + 2 K + 2 V tiles of 64 x (D + pad): 87,040 B at
//     D = 64 f32 (two blocks per SM), 46,080 B in bf16/f16.
//   * Grid (H, B, tiles) with the tile index slowest and reversed: the
//     longest causal tiles start first and the short ones fill the tail.
//     Causal tiles above the diagonal are never visited; only the
//     diagonal tile and a tail tile past T are masked.
//   * Not used: `wgmma`, TMA and warp specialisation (flash_bwd.cu's note
//     says why TF32 `wgmma` does not fit the accumulator-fed second
//     product); `mma.sync` already puts both products on the tensor cores.

#include "flash_common.cuh"

namespace {

template <typename T, int DMAX>
constexpr int fwd_smem_bytes() {
  return 5 * kB * tile_ld<T, DMAX>() * (int)sizeof(T);
}

// One pass of a block's K loop over key tiles 0..nk-1 (tile 0 already in
// flight in buffer 0 of sK/sV) with split G, then O and lse of this warp's
// 16 rows stored. Returns NaN if a row sum or an accumulator of this lane
// was not finite before the division, else 0: a score that is not finite
// makes its row's P (so l) NaN, unless it is masked, where -inf replaces
// it. kb, vb, ob point at time step 0 of this (batch, head); Q is this
// warp's 16 rows in shared memory, pre-scaled in f32.
template <typename T, int DMAX, bool G>
__device__ __forceinline__ float fwd_pass(
    const T* sQw, T* sK, T* sV, const T* __restrict__ kb,
    const T* __restrict__ vb, T* __restrict__ ob, float* __restrict__ lse_bh,
    long long rs, int t_len, int d, int qt, int nk, int causal, int vec,
    float scale) {
  using M = Mma<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  // Q's A fragments stay in registers across the K loop, except f32 at
  // D = 128 (DMAX registers of split fragments would spill) and in the
  // guarded pass (its split is wider)
  constexpr bool kQRegs = !(kF32 && DMAX > 64) && !G;
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int TILE = kB * LD;
  constexpr int NKK = DMAX / M::kK;  // k steps of S = Q K^T
  const int g = frag_g(), t4 = frag_t();
  const int q0 = qt * kB + (threadIdx.x >> 5) * 16;  // this warp's first row

  typename M::template A<G> qa[kQRegs ? NKK : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
      qa[kk] = M::template load_a<G>(sQw + kk * M::kK, LD);
  }

  int qpos[2];
  float m[2], l[2];  // l: this lane's part of the row sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + g + 8 * r;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed for all; tile j-1 fully consumed
    if (j + 1 < nk) {
      const int nb = (j + 1) & 1;
      load_tile<T, DMAX>(sK + nb * TILE, kb, rs, (j + 1) * kB, t_len, d, vec);
      load_tile<T, DMAX>(sV + nb * TILE, vb, rs, (j + 1) * kB, t_len, d, vec);
    }
    cp_async_commit();
    const T* cK = sK + (j & 1) * TILE;
    const T* cV = sV + (j & 1) * TILE;
    const int k0 = j * kB;

    // S (16 x 64) = Q K^T
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      typename M::template A<G> a;
      if constexpr (kQRegs) {
        a = qa[kk];
      } else {
        a = M::template load_a<G>(sQw + kk * M::kK, LD);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
        M::template mma<G>(
            s[n], a, M::template load_b_rows<G>(cK + n * 8 * LD + kk * M::kK, LD));
    }
    if constexpr (!kF32) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    }
    // only the diagonal tile and a tail tile past T hold masked entries
    if ((causal && j == qt) || k0 + kB > t_len) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qp = qpos[e >> 1];
          if (kpos >= t_len || (causal && kpos > qp)) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax on the accumulator layout: row r of the fragment is
    // s[n][2r], s[n][2r + 1] over n, spread over the quad's 4 lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mb = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mb = fmaxf(mb, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float m_new = fmaxf(m[r], mb);
      // a row with nothing visible yet keeps m == -inf: guard the shift
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf((m[r] == -INFINITY ? shift : m[r]) - shift);
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = expf(s[n][e] - shift);  // masked: exp(-inf) = 0
          rsum += s[n][e];
        }
      }
      l[r] = l[r] * corr + rsum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
    tile_pb<T, DMAX, G>(acc, s, cV);  // O += P V
  }

  float bad = nonfinite(nonfinite(0.f, l[0]), l[1]);
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) bad = nonfinite(bad, acc[n][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float l_safe = lt == 0.f ? 1.f : lt;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      acc[n][2 * r] *= inv;
      acc[n][2 * r + 1] *= inv;
    }
    if (t4 == 0 && qpos[r] < t_len)
      lse_bh[qpos[r]] = m[r] == -INFINITY ? -INFINITY : m[r] + logf(l_safe);
  }
  store_rows<T, DMAX>(ob, acc, qpos, rs, t_len, d);
  return bad;
}

// The guarded pass, compiled apart from the kernel so that its wider split
// leaves the first pass's registers and schedule as they were
template <typename T, int DMAX>
__device__ __noinline__ void fwd_pass_guarded(
    const T* sQw, T* sK, T* sV, const T* __restrict__ kb,
    const T* __restrict__ vb, T* __restrict__ ob, float* __restrict__ lse_bh,
    long long rs, int t_len, int d, int qt, int nk, int causal, int vec,
    float scale) {
  fwd_pass<T, DMAX, true>(sQw, sK, sV, kb, vb, ob, lse_bh, rs, t_len, d, qt,
                          nk, causal, vec, scale);
}

// DMAX: compile-time head-dim capacity (32, 64 or 128); d <= DMAX at run
// time, columns past d are zero in shared memory and never written out.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t_len, int heads, int d,
                     float scale, int causal, int vec) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int TILE = kB * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + TILE;      // two buffers
  T* sV = sK + 2 * TILE;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the tile index is the grid's slowest dimension, so blocks start tile
  // by tile over all (b, h); reversed, the longest causal tiles go first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kB;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long rs = (long long)heads * d;
  const long long base = (long long)b * t_len * rs + (long long)h * d;
  // causal: key tiles past the diagonal tile are fully masked
  const int nk = causal ? qt + 1 : (t_len + kB - 1) / kB;
  const T* kb = k + base;
  const T* vb = v + base;
  float* lse_bh = lse + ((long long)b * heads + h) * t_len;

  if (vec && d < DMAX) zero_pad_columns<T, DMAX>(sQ, 5, d);
  load_tile<T, DMAX>(sQ, q + base, rs, q0, t_len, d, vec);
  load_tile<T, DMAX>(sK, kb, rs, 0, t_len, d, vec);
  load_tile<T, DMAX>(sV, vb, rs, 0, t_len, d, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows; only this warp reads them
  T* sQw = sQ + warp * 16 * LD;
  if constexpr (kF32) {
    for (int i = lane; i < 16 * DMAX; i += 32) {
      float* e = sQw + (i / DMAX) * LD + (i % DMAX);
      *e *= scale;
    }
    __syncwarp();
  }

  const float bad = fwd_pass<T, DMAX, false>(
      sQw, sK, sV, kb, vb, o + base, lse_bh, rs, t_len, d, qt, nk, causal,
      vec, scale);
  if constexpr (kF32) {
    // a non-finite input (or an overflow) met anywhere in the block: every
    // warp is past the loop, so restart the K/V stream and run it again
    // with the guarded split; its O and lse replace the first pass's
    if (__syncthreads_or(bad != 0.f)) {
      load_tile<T, DMAX>(sK, kb, rs, 0, t_len, d, vec);
      load_tile<T, DMAX>(sV, vb, rs, 0, t_len, d, vec);
      cp_async_commit();
      fwd_pass_guarded<T, DMAX>(sQw, sK, sV, kb, vb, o + base, lse_bh, rs,
                                t_len, d, qt, nk, causal, vec, scale);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int t_len, int heads, int d, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = fwd_smem_bytes<T, DMAX>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DMAX>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, batch, (t_len + kB - 1) / kB);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t_len, heads, d, scale, causal, can_vectorize<T>(d, {q, k, v}));
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
  if (bad_shape(batch, t_len, heads, d)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || t_len == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
    case 2: return dispatch_d<__half>(q, k, v, o, lse, batch, t_len, heads, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
