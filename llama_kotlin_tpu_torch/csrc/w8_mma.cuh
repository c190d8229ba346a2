// The W8A8 product on int8 tensor cores, for row counts where kernel 5's
// warp-per-row walk (qmm_w8.cu) spends its time on activation traffic:
// kernel 5 above its row threshold T5, both branches.  NP activation planes
// of B rows each (row p*B + b of x8/sx is plane p of batch row b) are
// stacked as the A operand's MP = 16 MT rows; the weight rows are the B
// operand; the planes of a batch row are summed in the epilogue.
//
//   y[b, n] = sum_p sum_s sx[pB+b, s] * sum_{g in s} s_eff[n, g] P_g(pB+b, n)
//
// with P_g the exact int32 partial of group g (GS = 16 or 32 elements) and
// s the 256-element superblock: each group's partial is scaled by its f32
// s_eff, and sx applies once a superblock (JAX forms (P s_eff) sx per
// group: the f32 order differs, the integer partials do not).
//
// A block takes BN = 128 weight rows (8 warps of 16) and a K range of whole
// superblocks (split K, summed in split order by the last block to arrive).
// A 3-stage cp.async ring holds, per superblock, the rows' 256 code bytes
// (the fold's int8 codes are k-contiguous, the .col B layout, so they need
// no unpacking), their 256/GS scales, and the MP activation rows with their
// scale.  ldmatrix gives both operands' fragments from rows padded to 272
// bytes (eight rows on distinct banks).  One product is one group: mma.sync
// m16n8k16 for a 16-group (two groups never share a k32 product, so every
// group partial stays exact), m16n8k32 for a 32-group.  Its accumulator
// starts at 0x4B400000, so the result's bits are the f32 2^23 + 2^22 + P
// and one FADD gives P (exact_f), then one FMA scales it: a conversion
// instruction a group and element would run at a quarter of that rate.
#pragma once

#include "mma_pipe.cuh"

namespace w8mma {

// s8 m16n8k16 (one 16-group), the exact int32 products plus
// 0x4B400000 (mma_pipe.cuh's MAGIC_I): a[0] row g at k 4t..4t+3, a[1] row
// g+8; b[0] the same k of column g.
__device__ __forceinline__ void mma_s8_k16_magic(int c[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "r"(MAGIC_I));
}

constexpr int THREADS = 256, BN = 128, STAGES = 3;  // 8 warps of 16 weight rows
constexpr int C_LD = 272;  // bytes a code row (256 + 16: ldmatrix conflict-free)
constexpr int X_LD = 272;  // bytes an activation row

template <int GS, int MT>
struct Tile {
  static constexpr int MP = 16 * MT;
  static constexpr int G = 256 / GS;  // groups a superblock
  static constexpr int S_LD = G + 4;  // floats a scale row (conflict-free LDS.128 / LDS.64)
  static constexpr int C_BYTES = BN * C_LD, S_BYTES = BN * S_LD * 4, X_BYTES = MP * X_LD;
  static constexpr int STAGE = C_BYTES + S_BYTES + X_BYTES + MP * 4;
  static constexpr int SMEM = STAGE * STAGES;
};

// Copies of superblock s into stage st: rows >= rows_live of the
// activations and >= n of the weights are zero-filled.
template <int GS, int MT>
__device__ __forceinline__ void load_sb(uint8_t* st, int s, const int8_t* __restrict__ x8,
                                        const float* __restrict__ sx, int rows_live,
                                        const int8_t* __restrict__ codes,
                                        const float* __restrict__ gs, int n, int K, int n0) {
  using T = Tile<GS, MT>;
  constexpr int SC = T::G / 4;  // 16-byte copies a scale row
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BN * 16; idx += THREADS) {
    const int r = idx >> 4, c = idx & 15;
    const bool ok = n0 + r < n;
    cp_async16(st + r * C_LD + c * 16, codes + (size_t)(ok ? n0 + r : 0) * K + s * 256 + c * 16,
               ok ? 16 : 0);
  }
  float* ss = reinterpret_cast<float*>(st + T::C_BYTES);
  for (int idx = tid; idx < BN * SC; idx += THREADS) {
    const int r = idx / SC, c = idx % SC;
    const bool ok = n0 + r < n;
    cp_async16(ss + r * T::S_LD + c * 4,
               gs + (size_t)(ok ? n0 + r : 0) * (K / GS) + s * T::G + c * 4, ok ? 16 : 0);
  }
  uint8_t* xs = st + T::C_BYTES + T::S_BYTES;
  for (int idx = tid; idx < T::MP * 16; idx += THREADS) {
    const int r = idx >> 4, c = idx & 15;
    const bool ok = r < rows_live;
    cp_async16(xs + r * X_LD + c * 16, x8 + (size_t)(ok ? r : 0) * K + s * 256 + c * 16,
               ok ? 16 : 0);
  }
  float* sxs = reinterpret_cast<float*>(xs + T::X_BYTES);
  for (int r = tid; r < T::MP; r += THREADS) {
    const bool ok = r < rows_live;
    cp_async4(sxs + r, sx + (size_t)(ok ? r : 0) * (K / 256) + s, ok ? 4 : 0);
  }
}

// One superblock's products and scaling into acc[mt][nt][e] (activation
// row mt*16 + g (+8 for e >= 2), weight row warp*16 + 8 nt + 2t + (e & 1)).
// The superblock is walked in quads of 64 bytes: 64 / GS groups each.
template <int GS, int MT>
__device__ __forceinline__ void sb_step(const uint8_t* st, float (&acc)[MT][2][4], int warp,
                                        int lane) {
  using T = Tile<GS, MT>;
  constexpr int GQ = 64 / GS;  // groups a quad
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // the ldmatrix row this lane names, its matrix
  const uint8_t* cs = st;
  const float* ss = reinterpret_cast<const float*>(st + T::C_BYTES);
  const uint8_t* xs = st + T::C_BYTES + T::S_BYTES;
  const float* sxs = reinterpret_cast<const float*>(xs + T::X_BYTES);
  float part[MT][2][4];  // this superblock's sum over its groups
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll(MT == 1 ? 4 : 1)  // above one m16 tile, one quad's fragments at a time
  for (int q = 0; q < 4; ++q) {
    // B: matrix m of b[nt] is bytes 64q + 16m of weight rows warp*16 + 8nt + 0..7
    uint32_t b[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      ldmatrix_x4(b[nt], cs + (warp * 16 + nt * 8 + lr) * C_LD + q * 64 + lm * 16);
    float sc[2][2][GQ];  // the quad's group scales of weight rows 8nt + 2t + j
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* sp = ss + (warp * 16 + nt * 8 + 2 * t + j) * T::S_LD + q * GQ;
        if constexpr (GS == 16) {
          const float4 v = *reinterpret_cast<const float4*>(sp);
          sc[nt][j][0] = v.x;
          sc[nt][j][1] = v.y;
          sc[nt][j][2] = v.z;
          sc[nt][j][3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(sp);
          sc[nt][j][0] = v.x;
          sc[nt][j][1] = v.y;
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* xrow = xs + (mt * 16 + lr + (lm & 1) * 8) * X_LD + q * 64;
#pragma unroll
      for (int m = 0; m < GQ; ++m) {
        int p[2][4];
        if constexpr (GS == 16) {
          // one x4 holds groups m and m + 1: rows 0-7 and 8-15 of each
          if (m % 2) continue;
          uint32_t a4[4];
          ldmatrix_x4(a4, xrow + (m + (lm >> 1)) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t a[2] = {a4[2 * h], a4[2 * h + 1]};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma_s8_k16_magic(p[nt], a, b[nt][m + h]);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                part[mt][nt][e] = fmaf(sc[nt][e & 1][m + h], exact_f(p[nt][e]), part[mt][nt][e]);
            }
          }
        } else {
          // group m: a[0], a[1] its bytes 0-15 of rows 0-7, 8-15; a[2], a[3] bytes 16-31
          uint32_t a[4];
          ldmatrix_x4(a, xrow + m * 32 + (lm >> 1) * 16);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint32_t bb[2] = {b[nt][2 * m], b[nt][2 * m + 1]};
            mma_s8_magic(p[nt], a, bb);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              part[mt][nt][e] = fmaf(sc[nt][e & 1][m], exact_f(p[nt][e]), part[mt][nt][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float sx0 = sxs[mt * 16 + g], sx1 = sxs[mt * 16 + g + 8];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += (e >= 2 ? sx1 : sx0) * part[mt][nt][e];
  }
}

// y [B, n] = the sum of the NP planes' rows; x8 [NP B, K] int8, sx
// [NP B, K/256] f32; codes [n, K] int8; gs [n, K/GS] f32.  Grid
// (ceil(n / BN), 1, splits); ws [splits, B, n] f32 and cnt (one int a
// column tile, zero) when splits > 1.
template <int GS, int NP, int MT>
__global__ void __launch_bounds__(THREADS, 1)
w8_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx, int B,
              const int8_t* __restrict__ codes, const float* __restrict__ gs, int n, int K,
              float* __restrict__ y, int splits, float* __restrict__ ws, int* __restrict__ cnt) {
  using T = Tile<GS, MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN, z = blockIdx.z;
  int s0, s1;
  split_range(z, splits, K / 256, &s0, &s1);
  const int ns = s1 - s0, rows_live = NP * B;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns)
      load_sb<GS, MT>(smem + i * T::STAGE, s0 + i, x8, sx, rows_live, codes, gs, n, K, n0);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ns)
      load_sb<GS, MT>(smem + (nxt % STAGES) * T::STAGE, s0 + nxt, x8, sx, rows_live, codes, gs,
                      n, K, n0);
    cp_async_commit();
    sb_step<GS, MT>(smem + (i % STAGES) * T::STAGE, acc, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
  store_planes<NP, MT, BN, THREADS>(smem, acc, B, n, n0, warp, lane >> 2, lane & 3, y, splits,
                                    ws, cnt, z);
}

// --- kernel 6's tile (qmm_int8.cu): the Q8F product, one scale a row and
// superblock on both sides (GS = 256, one group a superblock) ---------------
//
//   y[b, n] = sum_s P_s(b, n) * (sx[b, s] * sw[n, s]),   P_s exact
//
// The ring, fragments and split K of the tile above; the stage holds the
// superblock's 256 code bytes and one scale of each of the block's BN
// weight rows, and the 256 code bytes and scale of each of its MP = 16 MT
// activation rows (row tile blockIdx.y of the M rows).  The superblock's
// eight k32 products chain into one int32 accumulator that starts at
// 0x4B400000: |P_s| <= 256 * 127 * 128 < 2^22 (x codes are clipped to
// +-127, Q8F weight codes lie in [-127, 127]), so one FADD gives P_s.
template <int MT>
struct Q8fTile {
  static constexpr int MP = 16 * MT;
  static constexpr int C_BYTES = BN * C_LD, X_BYTES = MP * X_LD;
  static constexpr int STAGE = C_BYTES + BN * 4 + X_BYTES + MP * 4;
  static constexpr int SMEM = STAGE * STAGES;
};

// s8 m16n8k32 into c (int32, accumulating).
__device__ __forceinline__ void mma_s8_acc(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies of superblock s into stage st: activation rows m0 .. m0 + MP - 1
// (zero from M on) and weight rows n0 .. n0 + BN - 1 (zero from n on).
template <int MT>
__device__ __forceinline__ void q8f_load(uint8_t* st, int s, const int8_t* __restrict__ x8,
                                         const float* __restrict__ sx, int M, int m0,
                                         const int8_t* __restrict__ codes,
                                         const float* __restrict__ sw, int n, int K, int n0) {
  using T = Q8fTile<MT>;
  const int tid = threadIdx.x, S = K / 256;
  for (int idx = tid; idx < BN * 16; idx += THREADS) {
    const int r = idx >> 4, c = idx & 15;
    const bool ok = n0 + r < n;
    cp_async16(st + r * C_LD + c * 16, codes + (size_t)(ok ? n0 + r : 0) * K + s * 256 + c * 16,
               ok ? 16 : 0);
  }
  uint8_t* xs = st + T::C_BYTES + BN * 4;
  for (int idx = tid; idx < T::MP * 16; idx += THREADS) {
    const int r = idx >> 4, c = idx & 15;
    const bool ok = m0 + r < M;
    cp_async16(xs + r * X_LD + c * 16, x8 + (size_t)(ok ? m0 + r : 0) * K + s * 256 + c * 16,
               ok ? 16 : 0);
  }
  if (tid < BN) {
    const bool ok = n0 + tid < n;
    cp_async4(reinterpret_cast<float*>(st + T::C_BYTES) + tid,
              sw + (size_t)(ok ? n0 + tid : 0) * S + s, ok ? 4 : 0);
  } else if (tid - BN < T::MP) {
    const int r = tid - BN;
    const bool ok = m0 + r < M;
    cp_async4(reinterpret_cast<float*>(xs + T::X_BYTES) + r,
              sx + (size_t)(ok ? m0 + r : 0) * S + s, ok ? 4 : 0);
  }
}

// One superblock's exact partials, scaled by sx sw, into acc[mt][nt][e]
// (activation row mt*16 + g (+8 for e >= 2), weight row warp*16 + 8 nt +
// 2t + (e & 1)).  The superblock is walked in quads of 64 bytes, two k32
// products each.
template <int MT>
__device__ __forceinline__ void q8f_step(const uint8_t* st, float (&acc)[MT][2][4], int warp,
                                         int lane) {
  using T = Q8fTile<MT>;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // the ldmatrix row this lane names, its matrix
  const uint8_t* cs = st;
  const float* sws = reinterpret_cast<const float*>(st + T::C_BYTES);
  const uint8_t* xs = st + T::C_BYTES + BN * 4;
  const float* sxs = reinterpret_cast<const float*>(xs + T::X_BYTES);
  int p[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[mt][nt][e] = MAGIC_I;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // B: matrix m of b[nt] is bytes 64q + 16m of weight rows warp*16 + 8nt + 0..7
    uint32_t b[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      ldmatrix_x4(b[nt], cs + (warp * 16 + nt * 8 + lr) * C_LD + q * 64 + lm * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* xrow = xs + (mt * 16 + lr + (lm & 1) * 8) * X_LD + q * 64;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bytes 32h .. 32h + 31 of the quad: a[0], a[1] its bytes 0-15 of
        // rows 0-7, 8-15; a[2], a[3] bytes 16-31
        uint32_t a[4];
        ldmatrix_x4(a, xrow + h * 32 + (lm >> 1) * 16);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t bb[2] = {b[nt][2 * h], b[nt][2 * h + 1]};
          mma_s8_acc(p[mt][nt], a, bb);
        }
      }
    }
  }
  float sw2[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) sw2[nt][j] = sws[warp * 16 + nt * 8 + 2 * t + j];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float sx0 = sxs[mt * 16 + g], sx1 = sxs[mt * 16 + g + 8];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][nt][e] = fmaf(exact_f(p[mt][nt][e]), (e >= 2 ? sx1 : sx0) * sw2[nt][e & 1],
                              acc[mt][nt][e]);
  }
}

// y [M, n] = x8 [M, K] . codes [n, K]^T with the scales above.  Grid
// (ceil(n / BN), ceil(M / MP), splits); ws [splits, M, n] f32 and cnt (one
// zeroed int an output tile, row tile major) when splits > 1, summed in
// split order by the last block of each tile.
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
q8f_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx, int M,
               const int8_t* __restrict__ codes, const float* __restrict__ sw, int n, int K,
               float* __restrict__ y, int splits, float* __restrict__ ws, int* __restrict__ cnt) {
  using T = Q8fTile<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::MP, z = blockIdx.z;
  int s0, s1;
  split_range(z, splits, K / 256, &s0, &s1);
  const int ns = s1 - s0;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) q8f_load<MT>(smem + i * T::STAGE, s0 + i, x8, sx, M, m0, codes, sw, n, K, n0);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ns)
      q8f_load<MT>(smem + (nxt % STAGES) * T::STAGE, s0 + nxt, x8, sx, M, m0, codes, sw, n, K,
                   n0);
    cp_async_commit();
    q8f_step<MT>(smem + (i % STAGES) * T::STAGE, acc, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
  // the f32 tile [MP][BN] through shared memory (the ring, drained), then
  // rows m0 .. into y, or into split z's partial
  constexpr int O_LD = BN + 4;
  float* tile = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(mt * 16 + g + (e >= 2 ? 8 : 0)) * O_LD + warp * 16 + nt * 8 + 2 * t + (e & 1)] =
            acc[mt][nt][e];
  __syncthreads();
  const int rows = min(T::MP, M - m0);
  float* out = splits == 1 ? y : ws + (size_t)z * M * n;
  for (int idx = threadIdx.x; idx < rows * BN; idx += THREADS) {
    const int b = idx / BN, c = idx % BN;
    if (n0 + c < n) out[(size_t)(m0 + b) * n + n0 + c] = tile[b * O_LD + c];
  }
  if (splits > 1 && split_arrive_last(cnt, blockIdx.y * gridDim.x + blockIdx.x, splits))
    split_sum(ws, y, splits, (size_t)M * n, n, m0, rows, n0, min(BN, n - n0));
}

// Kernel 6's launch: row tiles of bm = 16, 32 or 64 rows (MT = bm / 16).
inline int q8f_launch(const int8_t* x8, const float* sx, int M, const int8_t* codes,
                      const float* sw, int n, int K, float* y, int bm, int splits, float* ws,
                      int* cnt, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (M + bm - 1) / bm, splits);
  if (bm == 16)
    LK_MMA_LAUNCH(q8f_mma_kernel<1>, Q8fTile<1>::SMEM, grid, stream, x8, sx, M, codes, sw, n, K,
                  y, splits, ws, cnt)
  if (bm == 32)
    LK_MMA_LAUNCH(q8f_mma_kernel<2>, Q8fTile<2>::SMEM, grid, stream, x8, sx, M, codes, sw, n, K,
                  y, splits, ws, cnt)
  if (bm == 64)
    LK_MMA_LAUNCH(q8f_mma_kernel<4>, Q8fTile<4>::SMEM, grid, stream, x8, sx, M, codes, sw, n, K,
                  y, splits, ws, cnt)
  return (int)cudaErrorInvalidValue;
}

// Launch with MT the smallest m16 count that holds NP B rows.
template <int GS, int NP>
inline int launch(const int8_t* x8, const float* sx, int B, const int8_t* codes, const float* gs,
                  int n, int K, float* y, int splits, float* ws, int* cnt, cudaStream_t stream) {
  const int rows = NP * B;
  const dim3 grid((n + BN - 1) / BN, 1, splits);
  if (rows <= 16)
    LK_MMA_LAUNCH((w8_mma_kernel<GS, NP, 1>), (Tile<GS, 1>::SMEM), grid, stream, x8, sx, B,
                  codes, gs, n, K, y, splits, ws, cnt)
  if (rows <= 32)
    LK_MMA_LAUNCH((w8_mma_kernel<GS, NP, 2>), (Tile<GS, 2>::SMEM), grid, stream, x8, sx, B,
                  codes, gs, n, K, y, splits, ws, cnt)
  if (rows <= 64)
    LK_MMA_LAUNCH((w8_mma_kernel<GS, NP, 4>), (Tile<GS, 4>::SMEM), grid, stream, x8, sx, B,
                  codes, gs, n, K, y, splits, ws, cnt)
  return (int)cudaErrorInvalidValue;
}
}  // namespace w8mma
