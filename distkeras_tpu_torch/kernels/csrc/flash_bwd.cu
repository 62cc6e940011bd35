// FlashAttention backward for Hopper (sm_90a), bound through a plain C
// interface: two kernels, dQ and dK/dV (the FlashAttention-2 split).
//
// Replaces: distkeras_tpu/ops/flash_attention.py `_dq_kernel` (dQ) and
// `_dkv_kernel` (dK/dV), launched by `_bwd` through `pl.pallas_call` (the
// custom VJP behind `flash_attention`).
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
// No atomics: each output row is owned by one block, so every run gives
// the same bits.
//
// Layout: q, k, v, O, dO, dQ, dK, dV are contiguous (B, T, H, D), the
// framework layout, read with strides (no transposes); lse and delta are
// (B, H, T) f32.
//
// Bound on an H100: operations. Causal T = 512, D = 64 does 6*D FLOPs per
// visible (query, key) pair in the dQ kernel (S, dP, dS.K) and 8*D in the
// dK/dV kernel (S, dP, P^T.dO, dS^T.Q) against a few bytes per pair. Every
// product runs on the tensor cores through `mma.sync`:
//   * f32 inputs: m16n8k8 TF32 with the 3xTF32 split (CUTLASS's
//     OpMultiplyAddFastF32): hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
//     hi), a.b ~ lo.hi + hi.lo + hi.hi accumulated in f32, which keeps the
//     error at f32 level (single-pass TF32 keeps ~3 digits). The bound is
//     3x the FLOPs at the 495 TFLOP/s TF32 peak.
//   * bf16/f16 inputs: m16n8k16 in one pass; P and dS are rounded to the
//     input type before the second product.
//
// Design (what it does about the SIMT kernels' limits):
//   * Tiles: 64 query rows x 64 key rows, one 128-thread block (four warps,
//     each owning 16 rows) per (b, h, 64-row tile): per query tile for dQ,
//     per key tile for dK/dV. D <= 128, zero-padded to the 32/64/128
//     instantiation.
//   * Register blocking: S and dP (dK/dV: S^T and dP^T, computed directly
//     as K.Q^T and V.dO^T) live in mma accumulators, 16 x 64 per warp.
//     The second product takes P/dS straight from those registers as its A
//     operand: for TF32 the k index of an m16n8k8 A fragment is permuted
//     (k = tig <-> column 2*tig, k = tig + 4 <-> 2*tig + 1) and the B
//     fragment reads its rows in the same order; for 16-bit types the
//     m16n8k16 A fragment is the accumulator layout of two n-blocks. So
//     nothing of P or dS goes through shared memory, and one A fragment
//     feeds 8 (or D/8) n-blocks of 3 (or 1) MMAs each.
//   * Shared-memory rows are padded by 16 bytes (a row stride of D + 4
//     floats or D + 8 halves), which makes every fragment load
//     bank-conflict-free.
//   * Loads: the streamed tiles (K/V for dQ; Q/dO and their lse/delta rows
//     for dK/dV) are double-buffered with 16-byte `cp.async.cg` (4-byte for
//     the row statistics), rows past T zero-filled by the copy: tile j+1
//     loads while tile j computes, one __syncthreads per tile. A head dim
//     whose rows are not 16-byte multiples (or unaligned pointers) takes
//     plain element loads into the same buffers.
//   * Shared memory per block: 6 tiles of 64 x (D + pad) elements (dQ: Q,
//     dO, K[2], V[2]; dK/dV: K, V, Q[2], dO[2], plus 1 KB of lse/delta):
//     at D = 64, 104,448 B (dQ) and 105,472 B (dK/dV) in f32, 55,296 /
//     56,320 B in bf16/f16, so two blocks fit per SM; D = 128 f32 takes
//     202,752 B and runs one block per SM.
//   * Causal: dQ tile i visits key tiles 0..i and dK/dV tile j query tiles
//     j..; the grid is (H, B, tiles), so blocks start tile by tile, and
//     both kernels take the longest tiles first (the dQ kernel reverses
//     its query-tile index) so the short ones fill the tail.
//   * The 3xTF32 split rounds like cvt.rna.tf32.f32 but on the integer
//     pipe (add half an ulp, clear 13 bits): cvt issues at a quarter rate
//     on sm_90 and was the first version's bottleneck. Row-major operands
//     load with ldmatrix (8 x 4 f32 or 8 x 8 b16 matrices; .trans for the
//     16-bit k-major B), the k-major f32 B with 32-bit loads.
//   * Not used: `wgmma`. TF32 wgmma reads both operands K-major only, and
//     P^T.dO and dS^T.Q (and dS.K) need the key index as their K dimension
//     in the M-major layout the accumulators give: that would cost a
//     transpose through shared memory per tile. mma.sync already puts the
//     work on the tensor cores; wgmma with TMA and warp specialisation is
//     a later step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kB = 64;         // rows per tile, query and key tiles alike
constexpr int kThreads = 128;  // four warps of 16 rows each

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

// two floats rounded to T and packed (lo in the low half), one instruction
template <typename T>
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack_rn<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack_rn<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// row stride of a shared tile, in elements: D + 16 bytes
template <typename T, int DMAX>
__host__ __device__ constexpr int tile_ld() {
  return DMAX + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- async copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (16 or 0) of 16, zero-filling the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start loading a (64, DMAX) tile whose first row is time step t0 (src
// points at time step 0 of this (batch, head)): rows past t_len are zero.
// vec: 16-byte cp.async over the d real columns (columns d..DMAX were
// zeroed once by zero_pad_columns); else plain element loads of the whole
// padded width.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long row_stride, int t0,
                                          int t_len, int d, bool vec) {
  constexpr int LD = tile_ld<T, DMAX>();
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int cpr = d / E;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kB * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * E, t = t0 + r;
      const bool in = t < t_len;
      cp_async16(dst + r * LD + c, src + (long long)(in ? t : 0) * row_stride + c,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kB * DMAX; i += kThreads) {
      const int r = i / DMAX, e = i % DMAX, t = t0 + r;
      dst[r * LD + e] = (t < t_len && e < d)
                            ? src[(long long)t * row_stride + e]
                            : from_f32<T>(0.f);
    }
  }
}

// zero columns d..DMAX of `tiles` consecutive tiles (the async loads only
// write columns 0..d)
template <typename T, int DMAX>
__device__ __forceinline__ void zero_pad_columns(T* s, int tiles, int d) {
  constexpr int LD = tile_ld<T, DMAX>();
  const int w = DMAX - d;
  for (int i = threadIdx.x; i < tiles * kB * w; i += kThreads) {
    const int r = i / w;
    s[r * LD + d + (i - r * w)] = from_f32<T>(0.f);
  }
}

// ------------------------------------------------------ mma fragments
//
// Per lane: g = lane / 4 (the fragment's row group), t = lane % 4.
// Accumulator (16 x 8): c[0], c[1] at row g, columns 2t, 2t+1; c[2], c[3]
// at row g + 8. Fragment loaders take a pointer to the operand's (0, 0).

__device__ __forceinline__ int frag_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int frag_t() { return threadIdx.x & 3; }

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) done on the
// integer pipe: add half a TF32 ulp to the magnitude's bits, clear the 13
// low bits. The conversion unit that runs cvt issues at a quarter of the
// integer rate on sm_90, and the split converts every operand twice.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// ldmatrix: each lane of 0-31 (x4) or 0-15 (x2) gives the address of one
// 16-byte row of an 8 x 8 b16 (or 8 x 4 b32) matrix; lane (g, t) receives
// the 32 bits at row g, column t of each matrix (transposed with .trans,
// b16 only)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// the row (of 16 rows) and the 16-byte column block whose address lane l
// gives: x4 loads matrices (rows 0-7, block 0), (8-15, 0), (0-7, 1),
// (8-15, 1); x2 loads (rows 0-7, block 0), (0-7, 1)
__device__ __forceinline__ int ldm_row_x4() {
  return (threadIdx.x & 7) + (threadIdx.x & 8);
}
__device__ __forceinline__ int ldm_blk_x4() { return (threadIdx.x >> 4) & 1; }
__device__ __forceinline__ int ldm_row_x2() { return threadIdx.x & 7; }
__device__ __forceinline__ int ldm_blk_x2() { return (threadIdx.x >> 3) & 1; }

// 3xTF32 operand: x ~ hi + lo, both exact in TF32
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = to_tf32(x);
    lo[i] = to_tf32(x - __uint_as_float(hi[i]));
  }
  // split raw f32 bits in place (hi holds them on entry)
  __device__ __forceinline__ void split_all() {
#pragma unroll
    for (int i = 0; i < N; ++i) set(i, __uint_as_float(hi[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Mma;

// f32: m16n8k8 TF32, three passes (lo.hi + hi.lo + hi.hi)
template <>
struct Mma<float> {
  static constexpr int kK = 8;
  using A = Split<4>;
  using B = Split<2>;

  // A (16 x 8) of a row-major tile: a0..a3 at (g, t), (g + 8, t),
  // (g, t + 4), (g + 8, t + 4), one ldmatrix.x4 of 8 x 4 f32 matrices
  static __device__ __forceinline__ A load_a(const float* s, int ld) {
    A a;
    ldmatrix_x4(a.hi, s + ldm_row_x4() * ld + 4 * ldm_blk_x4());
    a.split_all();
    return a;
  }
  // B[k][n] = s[n * ld + k], the transpose of a row-major tile: b0, b1 at
  // (k = t, n = g), (t + 4, g), one ldmatrix.x2
  static __device__ __forceinline__ B load_b_rows(const float* s, int ld) {
    B b;
    ldmatrix_x2(b.hi, s + ldm_row_x2() * ld + 4 * ldm_blk_x2());
    b.split_all();
    return b;
  }
  // B[k][n] = s[k * ld + n] with k permuted as in a_from_acc: fragment row
  // t reads tile row 2t, fragment row t + 4 reads tile row 2t + 1
  static __device__ __forceinline__ B load_b_cols(const float* s, int ld) {
    const int g = frag_g(), t = frag_t();
    B b;
    b.set(0, s[2 * t * ld + g]);
    b.set(1, s[(2 * t + 1) * ld + g]);
    return b;
  }
  // A (16 x 8) from one accumulator n-block, k permuted (see load_b_cols)
  static __device__ __forceinline__ A a_from_acc(const float (*c)[4]) {
    A a;
    a.set(0, c[0][0]);
    a.set(1, c[0][2]);
    a.set(2, c[0][1]);
    a.set(3, c[0][3]);
    return a;
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// bf16 / f16: m16n8k16, one pass
template <typename T>
struct Mma16 {
  static constexpr int kK = 16;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  // A (16 x 16) of a row-major tile: pairs at (g, 2t), (g + 8, 2t),
  // (g, 2t + 8), (g + 8, 2t + 8), one ldmatrix.x4
  static __device__ __forceinline__ A load_a(const T* s, int ld) {
    A a;
    ldmatrix_x4(a.r, s + ldm_row_x4() * ld + 8 * ldm_blk_x4());
    return a;
  }
  // B[k][n] = s[n * ld + k]: pairs at (k = 2t, n = g), (2t + 8, g)
  static __device__ __forceinline__ B load_b_rows(const T* s, int ld) {
    B b;
    ldmatrix_x2(b.r, s + ldm_row_x2() * ld + 8 * ldm_blk_x2());
    return b;
  }
  // B[k][n] = s[k * ld + n]: the same pairs from k-major rows, one
  // ldmatrix.x2.trans (lanes 0-15 give rows k = 0..15)
  static __device__ __forceinline__ B load_b_cols(const T* s, int ld) {
    B b;
    ldmatrix_x2_trans(b.r, s + (threadIdx.x & 15) * ld);
    return b;
  }
  // A (16 x 16) from two accumulator n-blocks, rounded to T
  static __device__ __forceinline__ A a_from_acc(const float (*c)[4]) {
    A a;
    a.r[0] = pack_rn<T>(c[0][0], c[0][1]);
    a.r[1] = pack_rn<T>(c[0][2], c[0][3]);
    a.r[2] = pack_rn<T>(c[1][0], c[1][1]);
    a.r[3] = pack_rn<T>(c[1][2], c[1][3]);
    return a;
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    if constexpr (std::is_same<T, __half>::value) {
      asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]),
            "r"(b.r[0]), "r"(b.r[1]));
    } else {
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]),
            "r"(b.r[0]), "r"(b.r[1]));
    }
  }
};

template <>
struct Mma<__nv_bfloat16> : Mma16<__nv_bfloat16> {};
template <>
struct Mma<__half> : Mma16<__half> {};

// c (16 x 64) = A . B^T over DMAX: A is this warp's 16 rows of a row-major
// tile, B the 64 rows of another (S = Q K^T, dP = dO V^T, S^T = K Q^T, ...)
template <typename T, int DMAX>
__device__ __forceinline__ void tile_abt(float (&c)[8][4], const T* sa,
                                         const T* sb) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T, DMAX>();
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DMAX; k0 += M::kK) {
    const typename M::A a = M::load_a(sa + k0, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      M::mma(c[n], a, M::load_b_rows(sb + n * 8 * LD + k0, LD));
  }
}

// acc (16 x DMAX) += P . B: P (16 x 64) in accumulator registers, B the 64
// rows of a row-major tile (dQ += dS K, dV += P^T dO, dK += dS^T Q)
template <typename T, int DMAX>
__device__ __forceinline__ void tile_pb(float (&acc)[DMAX / 8][4],
                                        const float (&p)[8][4], const T* sb) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T, DMAX>();
#pragma unroll
  for (int kk = 0; kk < kB; kk += M::kK) {
    const typename M::A a = M::a_from_acc(p + kk / 8);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      M::mma(acc[n], a, M::load_b_cols(sb + kk * LD + n * 8, LD));
  }
}

// store this warp's 16 rows of a (16 x DMAX) accumulator; row r of the
// fragment is time step pos[r]
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[DMAX / 8][4],
                                           const int (&pos)[2],
                                           long long row_stride, int t_len,
                                           int d) {
  const int t = frag_t();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] >= t_len) continue;
    T* row = out + (long long)pos[r] * row_stride;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < d) row[c] = from_f32<T>(acc[n][2 * r]);
      if (c + 1 < d) row[c + 1] = from_f32<T>(acc[n][2 * r + 1]);
    }
  }
}

template <typename T, int DMAX>
constexpr int dq_smem_bytes() {
  return 6 * kB * tile_ld<T, DMAX>() * (int)sizeof(T);
}

template <typename T, int DMAX>
constexpr int dkv_smem_bytes() {
  return dq_smem_bytes<T, DMAX>() + 4 * kB * (int)sizeof(float);
}

// ------------------------------------------------------------------- dQ

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        int t_len, int heads, int d, float scale, int causal,
                        int vec) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int TILE = kB * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + TILE;
  T* sK = sdO + TILE;     // two buffers
  T* sV = sK + 2 * TILE;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = frag_g(), t4 = frag_t();
  // the tile index is the grid's slowest dimension, so blocks start tile
  // by tile over all (b, h); reversed, the longest causal tiles go first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kB;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long rs = (long long)heads * d;
  const long long base = (long long)b * t_len * rs + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * t_len;
  const int nk = causal ? qt + 1 : (t_len + kB - 1) / kB;

  if (vec && d < DMAX) zero_pad_columns<T, DMAX>(sQ, 6, d);
  load_tile<T, DMAX>(sQ, q + base, rs, q0, t_len, d, vec);
  load_tile<T, DMAX>(sdO, dout + base, rs, q0, t_len, d, vec);
  load_tile<T, DMAX>(sK, k + base, rs, 0, t_len, d, vec);
  load_tile<T, DMAX>(sV, v + base, rs, 0, t_len, d, vec);
  cp_async_commit();

  // delta = rowsum(dO * O) for the warp's 16 rows, read while the first
  // tiles land; each lane keeps its fragment rows' (g, g + 8)
  float dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int t = q0 + warp * 16 + i;
    float part = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < DMAX; c0 += 32) {
      const int c = c0 + lane;
      if (t < t_len && c < d) {
        const long long at = base + (long long)t * rs + c;
        part += to_f32(dout[at]) * to_f32(o[at]);
      }
    }
    part = warp_sum(part);
    if (i == g) dlt[0] = part;
    if (i == g + 8) dlt[1] = part;
    if (lane == 0 && t < t_len) delta[stat + t] = part;
  }
  int qpos[2];
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + warp * 16 + g + 8 * r;
    shift[r] = 0.f;
    if (qpos[r] < t_len) {
      const float l = lse[stat + qpos[r]];
      shift[r] = l == -INFINITY ? 0.f : l;  // a row that attends nothing
    }
  }

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed for all; tile j-1 fully consumed
    if (j + 1 < nk) {
      const int nb = (j + 1) & 1;
      load_tile<T, DMAX>(sK + nb * TILE, k + base, rs, (j + 1) * kB, t_len, d, vec);
      load_tile<T, DMAX>(sV + nb * TILE, v + base, rs, (j + 1) * kB, t_len, d, vec);
    }
    cp_async_commit();
    const T* cK = sK + (j & 1) * TILE;
    const T* cV = sV + (j & 1) * TILE;
    const int k0 = j * kB;

    float p[8][4], ds[8][4];
    tile_abt<T, DMAX>(p, sQ + warp * 16 * LD, cK);
    tile_abt<T, DMAX>(ds, sdO + warp * 16 * LD, cV);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = kpos < t_len && qpos[r] < t_len &&
                        (!causal || kpos <= qpos[r]);
        const float pv = ok ? expf(scale * p[n][e] - shift[r]) : 0.f;
        ds[n][e] = pv * (ds[n][e] - dlt[r]) * scale;
      }
    }
    tile_pb<T, DMAX>(acc, ds, cK);
  }
  store_rows<T, DMAX>(dq + base, acc, qpos, rs, t_len, d);
}

// ----------------------------------------------------------------- dK/dV

// Start loading query tile t0's lse and delta rows (64 f32 each): threads
// 0-63 copy lse, 64-127 delta; rows past t_len are zero.
__device__ __forceinline__ void load_stats(float* s_lse, float* s_dlt,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ dlt,
                                           int t0, int t_len) {
  const int r = threadIdx.x & (kB - 1), t = t0 + r;
  const bool in = t < t_len;
  const bool is_lse = threadIdx.x < kB;
  cp_async4((is_lse ? s_lse : s_dlt) + r, (is_lse ? lse : dlt) + (in ? t : 0),
            in ? 4 : 0);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int t_len, int heads, int d,
                         float scale, int causal, int vec) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int TILE = kB * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TILE;
  T* sQ = sV + TILE;       // two buffers
  T* sdO = sQ + 2 * TILE;  // two buffers
  float* sLse = reinterpret_cast<float*>(sdO + 2 * TILE);  // [2][kB]
  float* sDlt = sLse + 2 * kB;                             // [2][kB]

  const int warp = threadIdx.x >> 5;
  const int g = frag_g(), t4 = frag_t();
  // the tile index is the grid's slowest dimension; under causal masking
  // the first key tiles see the most queries, so they start first
  const int kt = blockIdx.z;
  const int k0 = kt * kB;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long rs = (long long)heads * d;
  const long long base = (long long)b * t_len * rs + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * t_len;
  // causal: query tiles that end before this key tile starts are fully
  // masked; start at the diagonal
  const int q_start = causal ? kt : 0;
  const int n_it = (t_len + kB - 1) / kB - q_start;

  if (vec && d < DMAX) zero_pad_columns<T, DMAX>(sK, 6, d);
  load_tile<T, DMAX>(sK, k + base, rs, k0, t_len, d, vec);
  load_tile<T, DMAX>(sV, v + base, rs, k0, t_len, d, vec);
  load_tile<T, DMAX>(sQ, q + base, rs, q_start * kB, t_len, d, vec);
  load_tile<T, DMAX>(sdO, dout + base, rs, q_start * kB, t_len, d, vec);
  load_stats(sLse, sDlt, lse + stat, delta + stat, q_start * kB, t_len);
  cp_async_commit();

  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + warp * 16 + g + 8 * r;

  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int j = 0; j < n_it; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed for all; tile j-1 fully consumed
    if (j + 1 < n_it) {
      const int nb = (j + 1) & 1, t0 = (q_start + j + 1) * kB;
      load_tile<T, DMAX>(sQ + nb * TILE, q + base, rs, t0, t_len, d, vec);
      load_tile<T, DMAX>(sdO + nb * TILE, dout + base, rs, t0, t_len, d, vec);
      load_stats(sLse + nb * kB, sDlt + nb * kB, lse + stat, delta + stat, t0,
                 t_len);
    }
    cp_async_commit();
    const int cb = j & 1;
    const T* cQ = sQ + cb * TILE;
    const T* cdO = sdO + cb * TILE;
    const float* cLse = sLse + cb * kB;
    const float* cDlt = sDlt + cb * kB;
    const int q0 = (q_start + j) * kB;

    // P^T (16 keys x 64 queries) = exp(scale * K Q^T - lse), masked
    float p[8][4];
    tile_abt<T, DMAX>(p, sK + warp * 16 * LD, cQ);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = n * 8 + 2 * t4 + (e & 1);
        const int qp = q0 + col;
        const bool ok = qp < t_len && kpos[r] < t_len &&
                        (!causal || kpos[r] <= qp);
        const float l = cLse[col];
        const float sh = l == -INFINITY ? 0.f : l;  // a row that attends nothing
        p[n][e] = ok ? expf(scale * p[n][e] - sh) : 0.f;
      }
    }
    tile_pb<T, DMAX>(acc_v, p, cdO);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - delta) * scale
    float ds[8][4];
    tile_abt<T, DMAX>(ds, sV + warp * 16 * LD, cdO);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        ds[n][e] = p[n][e] * (ds[n][e] - cDlt[col]) * scale;
      }
    }
    tile_pb<T, DMAX>(acc_k, ds, cQ);  // dK += dS^T Q
  }
  store_rows<T, DMAX>(dk + base, acc_k, kpos, rs, t_len, d);
  store_rows<T, DMAX>(dv + base, acc_v, kpos, rs, t_len, d);
}

// above 48 KB of dynamic shared memory a kernel must opt in, and the
// largest carveout lets two blocks share an SM; once per instantiation
// (the attributes are per function, and a launch inside a CUDA-graph
// capture must not repeat the calls)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *configured = true;
  return err;
}

// 16-byte async copies need rows of whole 16-byte chunks and aligned bases
template <typename T>
int can_vectorize(int d, std::initializer_list<const void*> ptrs) {
  if ((d * (int)sizeof(T)) % 16 != 0) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return 1;
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              int batch, int t_len, int heads, int d, float scale, int causal,
              cudaStream_t stream) {
  const int bytes = dq_smem_bytes<T, DMAX>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DMAX>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, batch, (t_len + kB - 1) / kB);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), t_len, heads, d, scale,
      causal, can_vectorize<T>(d, {q, k, v, dout}));
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int batch, int t_len, int heads, int d, float scale, int causal,
               cudaStream_t stream) {
  const int bytes = dkv_smem_bytes<T, DMAX>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, DMAX>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, batch, (t_len + kB - 1) / kB);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, heads, d, scale,
      causal, can_vectorize<T>(d, {q, k, v, dout}));
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
         batch > 65535 || (t_len + kB - 1) / kB > 65535;
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
