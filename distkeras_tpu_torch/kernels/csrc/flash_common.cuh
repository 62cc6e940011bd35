// Shared pieces of the FlashAttention kernels for Hopper (sm_90a), included
// by flash_fwd.cu and flash_bwd.cu: tile geometry, dtype conversions,
// 16-byte `cp.async` tile loads, the `ldmatrix` fragment loaders, the
// 3xTF32 split (rounded on the integer pipe; plain, and guarded for a
// non-finite operand) and the `mma.sync` wrappers (m16n8k8 TF32 for f32,
// m16n8k16 for bf16/f16), the two tile products every kernel is built
// from, the row store and the launch helpers.
//
// Each source that includes this header builds into its own library, so
// the anonymous namespace gives each its own copy; kernels/build.py hashes
// this file into the name of every library built from a source that
// includes it, so an edit here rebuilds both.

#pragma once


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

// 3xTF32 operand: x ~ hi + lo, both exact in TF32. a.b is taken as
// a.lo.b.fin + a.fin.b.lo + a.hi.b.hi (Mma<float>::mma), where fin is the
// hi that the two cross terms read. Here fin is hi itself: an infinite x
// gives hi = inf and lo = tf32(inf - inf), where inf - inf is the card's
// canonical NaN 0x7fffffff and the rounding carries it into -0; a cross
// term inf * lo (or inf * -0) then turns a score NaN whenever the other
// operand's lo is 0 or has the other sign from its hi.
template <int N, bool kGuard = false>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = to_tf32(x);
    lo[i] = to_tf32(x - __uint_as_float(hi[i]));
  }
  __device__ __forceinline__ const uint32_t (&fin() const)[N] { return hi; }
  // split raw f32 bits in place (hi holds them on entry)
  __device__ __forceinline__ void split_all() {
#pragma unroll
    for (int i = 0; i < N; ++i) set(i, __uint_as_float(hi[i]));
  }
};

// The guarded split, which the kernels' second pass takes (see below):
// an infinite x keeps hi = +-inf but gets lo = 0 and fin = 0, so only the
// hi.hi term sees the infinity and a.b is what the exact f32 product gives
// (+-inf, or NaN for inf * 0); a NaN x stays NaN in all three (the plain
// split rounds the card's canonical NaN, 0x7fffffff, to -0). Every finite x
// splits exactly as above, so a finite product keeps its bits.
template <int N>
struct Split<N, true> {
  uint32_t hi[N], lo[N], hf[N];
  __device__ __forceinline__ void set(int i, float x) {
    const uint32_t h = to_tf32(x);
    const uint32_t l = to_tf32(x - __uint_as_float(h));
    const bool inf = fabsf(x) == INFINITY;
    const bool nan = x != x;
    hi[i] = inf ? __float_as_uint(x) : nan ? 0x7fffffffu : h;
    hf[i] = inf ? 0u : hi[i];
    lo[i] = inf ? 0u : nan ? 0x7fffffffu : l;
  }
  __device__ __forceinline__ const uint32_t (&fin() const)[N] { return hf; }
  __device__ __forceinline__ void split_all() {
#pragma unroll
    for (int i = 0; i < N; ++i) set(i, __uint_as_float(hi[i]));
  }
};

// The f32 kernels run each block's tile loop once with the plain split; a
// non-finite value in a pass's scores or accumulators (`nonfinite`) can
// only come from a non-finite input or an overflow, and then the block
// runs the loop again with the guarded split (a `__noinline__` copy of the
// pass, so the first pass keeps its registers). Finite inputs never take
// the second pass, so their results keep the plain split's bits; 16-bit
// products are exact and take no second pass.

// 0 while every value folded in is finite, NaN after an inf or a NaN
// (x * 0 is +-0 for finite x and NaN otherwise; no fast-math folds it)
__device__ __forceinline__ float nonfinite(float acc, float x) {
  return acc + x * 0.f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Mma;

// f32: m16n8k8 TF32, three passes (lo.fin + fin.lo + hi.hi). Every
// loader takes the split (G: guarded or plain).
template <>
struct Mma<float> {
  static constexpr int kK = 8;
  template <bool G>
  using A = Split<4, G>;
  template <bool G>
  using B = Split<2, G>;

  // A (16 x 8) of a row-major tile: a0..a3 at (g, t), (g + 8, t),
  // (g, t + 4), (g + 8, t + 4), one ldmatrix.x4 of 8 x 4 f32 matrices
  template <bool G>
  static __device__ __forceinline__ A<G> load_a(const float* s, int ld) {
    A<G> a;
    ldmatrix_x4(a.hi, s + ldm_row_x4() * ld + 4 * ldm_blk_x4());
    a.split_all();
    return a;
  }
  // B[k][n] = s[n * ld + k], the transpose of a row-major tile: b0, b1 at
  // (k = t, n = g), (t + 4, g), one ldmatrix.x2
  template <bool G>
  static __device__ __forceinline__ B<G> load_b_rows(const float* s, int ld) {
    B<G> b;
    ldmatrix_x2(b.hi, s + ldm_row_x2() * ld + 4 * ldm_blk_x2());
    b.split_all();
    return b;
  }
  // B[k][n] = s[k * ld + n] with k permuted as in a_from_acc: fragment row
  // t reads tile row 2t, fragment row t + 4 reads tile row 2t + 1
  template <bool G>
  static __device__ __forceinline__ B<G> load_b_cols(const float* s, int ld) {
    const int g = frag_g(), t = frag_t();
    B<G> b;
    b.set(0, s[2 * t * ld + g]);
    b.set(1, s[(2 * t + 1) * ld + g]);
    return b;
  }
  // A (16 x 8) from one accumulator n-block, k permuted (see load_b_cols)
  template <bool G>
  static __device__ __forceinline__ A<G> a_from_acc(const float (*c)[4]) {
    A<G> a;
    a.set(0, c[0][0]);
    a.set(1, c[0][2]);
    a.set(2, c[0][1]);
    a.set(3, c[0][3]);
    return a;
  }
  template <bool G>
  static __device__ __forceinline__ void mma(float (&c)[4], const A<G>& a,
                                             const B<G>& b) {
    mma_tf32(c, a.lo, b.fin());
    mma_tf32(c, a.fin(), b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// bf16 / f16: m16n8k16, one pass; products of 16-bit values are exact,
// so the split choice G has nothing to guard and is ignored
template <typename T>
struct Mma16 {
  static constexpr int kK = 16;
  struct Frag4 {
    uint32_t r[4];
  };
  struct Frag2 {
    uint32_t r[2];
  };
  template <bool G>
  using A = Frag4;
  template <bool G>
  using B = Frag2;

  // A (16 x 16) of a row-major tile: pairs at (g, 2t), (g + 8, 2t),
  // (g, 2t + 8), (g + 8, 2t + 8), one ldmatrix.x4
  template <bool G>
  static __device__ __forceinline__ Frag4 load_a(const T* s, int ld) {
    Frag4 a;
    ldmatrix_x4(a.r, s + ldm_row_x4() * ld + 8 * ldm_blk_x4());
    return a;
  }
  // B[k][n] = s[n * ld + k]: pairs at (k = 2t, n = g), (2t + 8, g)
  template <bool G>
  static __device__ __forceinline__ Frag2 load_b_rows(const T* s, int ld) {
    Frag2 b;
    ldmatrix_x2(b.r, s + ldm_row_x2() * ld + 8 * ldm_blk_x2());
    return b;
  }
  // B[k][n] = s[k * ld + n]: the same pairs from k-major rows, one
  // ldmatrix.x2.trans (lanes 0-15 give rows k = 0..15)
  template <bool G>
  static __device__ __forceinline__ Frag2 load_b_cols(const T* s, int ld) {
    Frag2 b;
    ldmatrix_x2_trans(b.r, s + (threadIdx.x & 15) * ld);
    return b;
  }
  // A (16 x 16) from two accumulator n-blocks, rounded to T
  template <bool G>
  static __device__ __forceinline__ Frag4 a_from_acc(const float (*c)[4]) {
    Frag4 a;
    a.r[0] = pack_rn<T>(c[0][0], c[0][1]);
    a.r[1] = pack_rn<T>(c[0][2], c[0][3]);
    a.r[2] = pack_rn<T>(c[1][0], c[1][1]);
    a.r[3] = pack_rn<T>(c[1][2], c[1][3]);
    return a;
  }
  template <bool G>
  static __device__ __forceinline__ void mma(float (&c)[4], const Frag4& a,
                                             const Frag2& b) {
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
// tile, B the 64 rows of another (S = Q K^T, dP = dO V^T, S^T = K Q^T, ...);
// G: the guarded split or the plain one
template <typename T, int DMAX, bool G>
__device__ __forceinline__ void tile_abt(float (&c)[8][4], const T* sa,
                                         const T* sb) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T, DMAX>();
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DMAX; k0 += M::kK) {
    const typename M::template A<G> a = M::template load_a<G>(sa + k0, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      M::template mma<G>(
          c[n], a, M::template load_b_rows<G>(sb + n * 8 * LD + k0, LD));
  }
}

// acc (16 x DMAX) += P . B: P (16 x 64) in accumulator registers, B the 64
// rows of a row-major tile (dQ += dS K, dV += P^T dO, dK += dS^T Q)
template <typename T, int DMAX, bool G>
__device__ __forceinline__ void tile_pb(float (&acc)[DMAX / 8][4],
                                        const float (&p)[8][4], const T* sb) {
  using M = Mma<T>;
  constexpr int LD = tile_ld<T, DMAX>();
#pragma unroll
  for (int kk = 0; kk < kB; kk += M::kK) {
    const typename M::template A<G> a = M::template a_from_acc<G>(p + kk / 8);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      M::template mma<G>(
          acc[n], a, M::template load_b_cols<G>(sb + kk * LD + n * 8, LD));
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

inline bool bad_shape(int batch, int t_len, int heads, int d) {
  return batch < 0 || t_len < 0 || heads < 0 || d < 1 || d > 128 ||
         batch > 65535 || (t_len + kB - 1) / kB > 65535;
}

}  // namespace
