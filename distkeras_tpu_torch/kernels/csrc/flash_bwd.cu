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
//   * A non-finite f32 input (see flash_fwd.cu's note): each kernel's tile
//     loop is a pass that reports a non-finite dS value or accumulator (dS
//     is checked before its split, which would turn the card's canonical
//     NaN into -0); a block that meets one runs its loop again with the
//     guarded split, which gives the exact f32 products. So a query row
//     with an infinite element gets dQ = 0 (its P is 0), dV stays finite,
//     and dK is NaN where 0 * inf makes JAX's NaN. Finite inputs keep their
//     bits.
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

#include "flash_common.cuh"

namespace {

template <typename T, int DMAX>
constexpr int dq_smem_bytes() {
  return 6 * kB * tile_ld<T, DMAX>() * (int)sizeof(T);
}

template <typename T, int DMAX>
constexpr int dkv_smem_bytes() {
  return dq_smem_bytes<T, DMAX>() + 4 * kB * (int)sizeof(float);
}

// ------------------------------------------------------------------- dQ

// One pass of a dQ block's loop over key tiles 0..nk-1 (tile 0 already in
// flight in buffer 0 of sK/sV) with split G, then this warp's 16 dQ rows
// stored. Returns NaN if a dS value or a dQ accumulator of this lane was
// not finite, else 0; dS is checked before dS K, whose split would round
// the card's canonical NaN to -0. dlt and shift are the lane's two rows'
// delta and lse shift; kb, vb, dqb point at time step 0 of this (batch,
// head).
template <typename T, int DMAX, bool G>
__device__ __forceinline__ float dq_pass(
    const T* sQw, const T* sdOw, T* sK, T* sV, const T* __restrict__ kb,
    const T* __restrict__ vb, T* __restrict__ dqb, long long rs, int t_len,
    int d, int q0w, int nk, int causal, int vec, float scale, float dlt0,
    float dlt1, float shift0, float shift1) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int TILE = kB * LD;
  const int g = frag_g(), t4 = frag_t();
  const float dlt[2] = {dlt0, dlt1};
  const float shift[2] = {shift0, shift1};
  const int qpos[2] = {q0w + g, q0w + g + 8};

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float bad = 0.f;

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

    float p[8][4], ds[8][4];
    tile_abt<T, DMAX, G>(p, sQw, cK);
    tile_abt<T, DMAX, G>(ds, sdOw, cV);
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
        bad = nonfinite(bad, ds[n][e]);
      }
    }
    tile_pb<T, DMAX, G>(acc, ds, cK);
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) bad = nonfinite(bad, acc[n][e]);
  store_rows<T, DMAX>(dqb, acc, qpos, rs, t_len, d);
  return bad;
}

// The guarded pass, compiled apart from the kernel (see flash_fwd.cu)
template <typename T, int DMAX>
__device__ __noinline__ void dq_pass_guarded(
    const T* sQw, const T* sdOw, T* sK, T* sV, const T* __restrict__ kb,
    const T* __restrict__ vb, T* __restrict__ dqb, long long rs, int t_len,
    int d, int q0w, int nk, int causal, int vec, float scale, float dlt0,
    float dlt1, float shift0, float shift1) {
  dq_pass<T, DMAX, true>(sQw, sdOw, sK, sV, kb, vb, dqb, rs, t_len, d, q0w,
                         nk, causal, vec, scale, dlt0, dlt1, shift0, shift1);
}

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
  const int g = frag_g();
  // the tile index is the grid's slowest dimension, so blocks start tile
  // by tile over all (b, h); reversed, the longest causal tiles go first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kB;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long rs = (long long)heads * d;
  const long long base = (long long)b * t_len * rs + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * t_len;
  const int nk = causal ? qt + 1 : (t_len + kB - 1) / kB;
  const T* kb = k + base;
  const T* vb = v + base;

  if (vec && d < DMAX) zero_pad_columns<T, DMAX>(sQ, 6, d);
  load_tile<T, DMAX>(sQ, q + base, rs, q0, t_len, d, vec);
  load_tile<T, DMAX>(sdO, dout + base, rs, q0, t_len, d, vec);
  load_tile<T, DMAX>(sK, kb, rs, 0, t_len, d, vec);
  load_tile<T, DMAX>(sV, vb, rs, 0, t_len, d, vec);
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
  const int q0w = q0 + warp * 16;  // this warp's first row
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0w + g + 8 * r;
    shift[r] = 0.f;
    if (qp < t_len) {
      const float l = lse[stat + qp];
      shift[r] = l == -INFINITY ? 0.f : l;  // a row that attends nothing
    }
  }

  const T* sQw = sQ + warp * 16 * LD;
  const T* sdOw = sdO + warp * 16 * LD;
  const float bad = dq_pass<T, DMAX, false>(
      sQw, sdOw, sK, sV, kb, vb, dq + base, rs, t_len, d, q0w, nk, causal,
      vec, scale, dlt[0], dlt[1], shift[0], shift[1]);
  if constexpr (std::is_same<T, float>::value) {
    // a non-finite input (or an overflow) met anywhere in the block:
    // restart the K/V stream and run the loop again with the guarded
    // split; its dQ replaces the first pass's
    if (__syncthreads_or(bad != 0.f)) {
      load_tile<T, DMAX>(sK, kb, rs, 0, t_len, d, vec);
      load_tile<T, DMAX>(sV, vb, rs, 0, t_len, d, vec);
      cp_async_commit();
      dq_pass_guarded<T, DMAX>(sQw, sdOw, sK, sV, kb, vb, dq + base, rs,
                               t_len, d, q0w, nk, causal, vec, scale, dlt[0],
                               dlt[1], shift[0], shift[1]);
    }
  }
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

// One pass of a dK/dV block's loop over query tiles q_start.. (the first
// already in flight in buffer 0 of sQ/sdO/sLse/sDlt) with split G, then
// this warp's 16 dK and dV rows stored. Returns NaN if a dS^T value or a
// dK/dV accumulator of this lane was not finite, else 0; dS^T = P^T * (...)
// carries a non-finite P too, and is checked before its split (see
// dq_pass). sKw, sVw: this warp's 16 key rows; qb, dob, dkb, dvb point at
// time step 0 of this (batch, head), lse_bh and dlt_bh at its statistics.
template <typename T, int DMAX, bool G>
__device__ __forceinline__ float dkv_pass(
    const T* sKw, const T* sVw, T* sQ, T* sdO, float* sLse, float* sDlt,
    const T* __restrict__ qb, const T* __restrict__ dob,
    const float* __restrict__ lse_bh, const float* __restrict__ dlt_bh,
    T* __restrict__ dkb, T* __restrict__ dvb, long long rs, int t_len, int d,
    int k0w, int q_start, int n_it, int causal, int vec, float scale) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int TILE = kB * LD;
  const int g = frag_g(), t4 = frag_t();
  const int kpos[2] = {k0w + g, k0w + g + 8};

  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  float bad = 0.f;

  for (int j = 0; j < n_it; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed for all; tile j-1 fully consumed
    if (j + 1 < n_it) {
      const int nb = (j + 1) & 1, t0 = (q_start + j + 1) * kB;
      load_tile<T, DMAX>(sQ + nb * TILE, qb, rs, t0, t_len, d, vec);
      load_tile<T, DMAX>(sdO + nb * TILE, dob, rs, t0, t_len, d, vec);
      load_stats(sLse + nb * kB, sDlt + nb * kB, lse_bh, dlt_bh, t0, t_len);
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
    tile_abt<T, DMAX, G>(p, sKw, cQ);
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
    tile_pb<T, DMAX, G>(acc_v, p, cdO);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - delta) * scale
    float ds[8][4];
    tile_abt<T, DMAX, G>(ds, sVw, cdO);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        ds[n][e] = p[n][e] * (ds[n][e] - cDlt[col]) * scale;
        bad = nonfinite(bad, ds[n][e]);
      }
    }
    tile_pb<T, DMAX, G>(acc_k, ds, cQ);  // dK += dS^T Q
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bad = nonfinite(nonfinite(bad, acc_k[n][e]), acc_v[n][e]);
  store_rows<T, DMAX>(dkb, acc_k, kpos, rs, t_len, d);
  store_rows<T, DMAX>(dvb, acc_v, kpos, rs, t_len, d);
  return bad;
}

// The guarded pass, compiled apart from the kernel (see flash_fwd.cu)
template <typename T, int DMAX>
__device__ __noinline__ void dkv_pass_guarded(
    const T* sKw, const T* sVw, T* sQ, T* sdO, float* sLse, float* sDlt,
    const T* __restrict__ qb, const T* __restrict__ dob,
    const float* __restrict__ lse_bh, const float* __restrict__ dlt_bh,
    T* __restrict__ dkb, T* __restrict__ dvb, long long rs, int t_len, int d,
    int k0w, int q_start, int n_it, int causal, int vec, float scale) {
  dkv_pass<T, DMAX, true>(sKw, sVw, sQ, sdO, sLse, sDlt, qb, dob, lse_bh,
                          dlt_bh, dkb, dvb, rs, t_len, d, k0w, q_start, n_it,
                          causal, vec, scale);
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
  const T* qb = q + base;
  const T* dob = dout + base;

  if (vec && d < DMAX) zero_pad_columns<T, DMAX>(sK, 6, d);
  load_tile<T, DMAX>(sK, k + base, rs, k0, t_len, d, vec);
  load_tile<T, DMAX>(sV, v + base, rs, k0, t_len, d, vec);
  load_tile<T, DMAX>(sQ, qb, rs, q_start * kB, t_len, d, vec);
  load_tile<T, DMAX>(sdO, dob, rs, q_start * kB, t_len, d, vec);
  load_stats(sLse, sDlt, lse + stat, delta + stat, q_start * kB, t_len);
  cp_async_commit();

  const T* sKw = sK + warp * 16 * LD;
  const T* sVw = sV + warp * 16 * LD;
  const int k0w = k0 + warp * 16;  // this warp's first key row
  const float bad = dkv_pass<T, DMAX, false>(
      sKw, sVw, sQ, sdO, sLse, sDlt, qb, dob, lse + stat, delta + stat,
      dk + base, dv + base, rs, t_len, d, k0w, q_start, n_it, causal, vec,
      scale);
  if constexpr (std::is_same<T, float>::value) {
    // a non-finite input (or an overflow) met anywhere in the block:
    // restart the Q/dO stream and run the loop again with the guarded
    // split; its dK and dV replace the first pass's
    if (__syncthreads_or(bad != 0.f)) {
      load_tile<T, DMAX>(sQ, qb, rs, q_start * kB, t_len, d, vec);
      load_tile<T, DMAX>(sdO, dob, rs, q_start * kB, t_len, d, vec);
      load_stats(sLse, sDlt, lse + stat, delta + stat, q_start * kB, t_len);
      cp_async_commit();
      dkv_pass_guarded<T, DMAX>(sKw, sVw, sQ, sdO, sLse, sDlt, qb, dob,
                                lse + stat, delta + stat, dk + base,
                                dv + base, rs, t_len, d, k0w, q_start, n_it,
                                causal, vec, scale);
    }
  }
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
