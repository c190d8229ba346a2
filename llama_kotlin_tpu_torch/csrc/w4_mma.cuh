// The W4A8 product on int8 tensor cores, for row counts where the
// warp-per-row walk of w4_dot.cuh spends its time on activation traffic
// (kernel 7 above its row threshold, qmm_w4x.cu).  NP activation planes of
// B rows each (row p*B + b of x8/sx/xsum is plane p of batch row b) are
// stacked as the A operand's MP = 16 MT rows; the weight rows are the
// B operand; the two planes of a batch row are summed in the epilogue.
//
//   y[b, n] = sum_p sum_s sx[pB+b, s] * sum_{g in s} (s_g P_g - m_g xsum[pB+b, g])
//
// with P_g the exact int32 partial of group g, q the raw code (low nibble,
// or high nibble ^ 8) and w = q s_g - m_g: legacy and precise folds keep
// m_adj in g_min, so m_g = g_min on lo groups and g_min + 8 s_g on hi
// groups (the pre-signed high nibble's bias), as w4_dot.cuh forms them.
//
// A block takes BN = 128 weight rows (8 warps of 16) and a K range of whole
// 256-element spans (split K, summed in split order by the last block to
// arrive).  A 4-stage cp.async ring holds, per span, the rows' 128 code
// bytes, their 8 group scales and mins, and the MP activation rows with
// their superblock scale and group sums.  One mma.sync m16n8k32 s8 is one
// 32-group: 32 code bytes hold a lo group (low nibbles) and the hi group
// 128 elements on (high nibbles); thread t of a quad takes code bytes
// 8t..8t+7 of the 32 and the same 8 activation bytes of the group, a
// permutation of k that both operands share.  Every weight byte is read
// once a block, and the activation tile is shared by the block's warps.
#pragma once

#include "mma_pipe.cuh"

namespace w4mma {
constexpr int THREADS = 256, BN = 128, STAGES = 4;  // 8 warps of 16 weight rows
constexpr int C_LD = 160;  // bytes a code row (128 + 32: conflict-free 8-byte loads)
constexpr int S_LD = 12;   // floats a scale/min row (8 + 4)
constexpr int X_LD = 288;  // bytes an activation row (256 + 32)
constexpr int XS_LD = 12;  // ints an xsum row (8 + 4)

template <int MT>
struct Tile {
  static constexpr int MP = 16 * MT;
  static constexpr int C_BYTES = BN * C_LD, S_BYTES = BN * S_LD * 4;
  static constexpr int X_BYTES = MP * X_LD, XS_BYTES = MP * XS_LD * 4, SX_BYTES = MP * 4;
  static constexpr int STAGE = C_BYTES + 2 * S_BYTES + X_BYTES + XS_BYTES + SX_BYTES;
  static constexpr int SMEM = STAGE * STAGES;
};

// Copies of span s into stage st: rows >= rows_live of the activations
// and >= n of the weights are zero-filled.
template <int MT>
__device__ __forceinline__ void load_span(uint8_t* st, int s, const int8_t* __restrict__ x8,
                                          const float* __restrict__ sx,
                                          const int* __restrict__ xsum, int rows_live,
                                          const uint8_t* __restrict__ codes,
                                          const float* __restrict__ gs,
                                          const float* __restrict__ gm, int n, int kc, int n0) {
  using T = Tile<MT>;
  const int tid = threadIdx.x, G = kc / 16, S = kc / 128;
  for (int idx = tid; idx < BN * 8; idx += THREADS) {
    const int r = idx >> 3, c = idx & 7;
    const bool ok = n0 + r < n;
    cp_async16(st + r * C_LD + c * 16, codes + (size_t)(ok ? n0 + r : 0) * kc + s * 128 + c * 16,
               ok ? 16 : 0);
  }
  float* ss = reinterpret_cast<float*>(st + T::C_BYTES);
  float* ms = ss + BN * S_LD;
  for (int idx = tid; idx < BN * 2; idx += THREADS) {
    const int r = idx >> 1, c = idx & 1;
    const bool ok = n0 + r < n;
    const size_t g = (size_t)(ok ? n0 + r : 0) * G + s * 8 + c * 4;
    cp_async16(ss + r * S_LD + c * 4, gs + g, ok ? 16 : 0);
    cp_async16(ms + r * S_LD + c * 4, gm + g, ok ? 16 : 0);
  }
  uint8_t* xs = st + T::C_BYTES + 2 * T::S_BYTES;
  for (int idx = tid; idx < T::MP * 16; idx += THREADS) {
    const int r = idx >> 4, c = idx & 15;
    const bool ok = r < rows_live;
    cp_async16(xs + r * X_LD + c * 16, x8 + (size_t)(ok ? r : 0) * 2 * kc + s * 256 + c * 16,
               ok ? 16 : 0);
  }
  int* xss = reinterpret_cast<int*>(xs + T::X_BYTES);
  for (int idx = tid; idx < T::MP * 2; idx += THREADS) {
    const int r = idx >> 1, c = idx & 1;
    const bool ok = r < rows_live;
    cp_async16(xss + r * XS_LD + c * 4, xsum + (size_t)(ok ? r : 0) * G + s * 8 + c * 4,
               ok ? 16 : 0);
  }
  float* sxs = reinterpret_cast<float*>(xss + T::MP * XS_LD);
  for (int r = tid; r < T::MP; r += THREADS) {
    const bool ok = r < rows_live;
    cp_async4(sxs + r, sx + (size_t)(ok ? r : 0) * S + s, ok ? 4 : 0);
  }
}

// One span's products and scaling into acc[mt][nt][e] (activation row
// mt*16 + g (+8 for e >= 2), weight row warp*16 + 8 nt + 2t + (e & 1)).
template <int MT>
__device__ __forceinline__ void span_step(const uint8_t* st, float acc[MT][2][4], int warp,
                                          int g, int t) {
  using T = Tile<MT>;
  const uint8_t* cs = st;
  const float* ss = reinterpret_cast<const float*>(st + T::C_BYTES);
  const float* ms = ss + BN * S_LD;
  const uint8_t* xs = st + T::C_BYTES + 2 * T::S_BYTES;
  const int* xss = reinterpret_cast<const int*>(xs + T::X_BYTES);
  const float* sxs = reinterpret_cast<const float*>(xss + T::MP * XS_LD);
  float sxr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    sxr[mt][0] = sxs[mt * 16 + g];
    sxr[mt][1] = sxs[mt * 16 + g + 8];
  }
  float part[MT][2][4];  // this span's sum over its 8 groups
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
  for (int gp = 0; gp < 4; ++gp) {
    // B fragments: code bytes 32 gp + 8t .. + 7 of weight row warp*16 + 8 nt + g
    uint32_t blo[2][2], bhi[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint2 w = *reinterpret_cast<const uint2*>(cs + (warp * 16 + nt * 8 + g) * C_LD +
                                                      gp * 32 + t * 8);
      blo[nt][0] = w.x & 0x0F0F0F0Fu;
      blo[nt][1] = w.y & 0x0F0F0F0Fu;
      bhi[nt][0] = ((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      bhi[nt][1] = ((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = gp + 4 * h;  // group of the span: lo 0..3, hi 4..7
      float sc[2][2], mn[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = warp * 16 + nt * 8 + 2 * t + j;
          sc[nt][j] = ss[col * S_LD + gi];
          mn[nt][j] = ms[col * S_LD + gi];
          if (h) mn[nt][j] += 8.f * sc[nt][j];
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = mt * 16 + g;
        const uint2 a0 = *reinterpret_cast<const uint2*>(xs + r0 * X_LD + gi * 32 + t * 8);
        const uint2 a1 = *reinterpret_cast<const uint2*>(xs + (r0 + 8) * X_LD + gi * 32 + t * 8);
        const uint32_t a[4] = {a0.x, a1.x, a0.y, a1.y};
        const float xg[2] = {(float)xss[r0 * XS_LD + gi], (float)xss[(r0 + 8) * XS_LD + gi]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          int p[4];
          mma_s8_zero(p, a, h ? bhi[nt] : blo[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // two FMAs: the f32 order is free
            part[mt][nt][e] = fmaf(sc[nt][e & 1], (float)p[e], part[mt][nt][e]);
            part[mt][nt][e] = fmaf(-mn[nt][e & 1], xg[e >> 1], part[mt][nt][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sxr[mt][e >> 1] * part[mt][nt][e];
}

// y [B, n] = the sum of the NP planes' rows; x8 [NP B, 2 kc] int8, sx
// [NP B, kc/128] f32, xsum [NP B, kc/16] int32; codes [n, kc] u8; gs, gm
// [n, kc/16] f32.  Grid (ceil(n / BN), 1, splits); ws [splits, B, n] f32
// and cnt (one int a column tile, zero) when splits > 1.
template <int NP, int MT>
__global__ void __launch_bounds__(THREADS, 1)
w4_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
              const int* __restrict__ xsum, int B, const uint8_t* __restrict__ codes,
              const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc,
              float* __restrict__ y, int splits, float* __restrict__ ws, int* __restrict__ cnt) {
  using T = Tile<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, z = blockIdx.z;
  int s0, s1;
  split_range(z, splits, kc / 128, &s0, &s1);
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
      load_span<MT>(smem + i * T::STAGE, s0 + i, x8, sx, xsum, rows_live, codes, gs, gm, n, kc,
                    n0);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ns)
      load_span<MT>(smem + (nxt % STAGES) * T::STAGE, s0 + nxt, x8, sx, xsum, rows_live, codes,
                    gs, gm, n, kc, n0);
    cp_async_commit();
    span_step<MT>(smem + (i % STAGES) * T::STAGE, acc, warp, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the f32 tile [MP][BN] through shared memory, then the plane sum of
  // each batch row in a fixed order (plane 0, then plane 1)
  constexpr int O_LD = BN + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(mt * 16 + g + (e >= 2 ? 8 : 0)) * O_LD + warp * 16 + nt * 8 + 2 * t +
             (e & 1)] = acc[mt][nt][e];
  __syncthreads();
  float* out = splits == 1 ? y : ws + (size_t)z * B * n;
  for (int idx = tid; idx < B * BN; idx += THREADS) {
    const int b = idx / BN, c = idx % BN;
    if (n0 + c >= n) continue;
    float v = tile[b * O_LD + c];
#pragma unroll
    for (int p = 1; p < NP; ++p) v += tile[(p * B + b) * O_LD + c];
    out[(size_t)b * n + n0 + c] = v;
  }
  if (splits > 1 && split_arrive_last(cnt, blockIdx.x, splits))
    split_sum(ws, y, splits, (size_t)B * n, n, 0, B, n0, min(BN, n - n0));
}

// Launch with MT the smallest m16 count that holds NP B rows.
template <int NP>
inline int launch(const int8_t* x8, const float* sx, const int* xsum, int B,
                  const uint8_t* codes, const float* gs, const float* gm, int n, int kc,
                  float* y, int splits, float* ws, int* cnt, cudaStream_t stream) {
  const int rows = NP * B;
  const dim3 grid((n + BN - 1) / BN, 1, splits);
#define LK_W4MMA(MTV)                                                                     \
  {                                                                                       \
    auto kern = w4_mma_kernel<NP, MTV>;                                                   \
    static bool sized = false;                                                            \
    if (!sized) {                                                                         \
      const cudaError_t err = cudaFuncSetAttribute(                                       \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<MTV>::SMEM);            \
      if (err != cudaSuccess) return (int)err;                                            \
      sized = true;                                                                       \
    }                                                                                     \
    kern<<<grid, THREADS, Tile<MTV>::SMEM, stream>>>(x8, sx, xsum, B, codes, gs, gm, n, kc, \
                                                     y, splits, ws, cnt);                 \
    return (int)cudaGetLastError();                                                       \
  }
  if (rows <= 16) LK_W4MMA(1)
  if (rows <= 32) LK_W4MMA(2)
  if (rows <= 64) LK_W4MMA(4)
#undef LK_W4MMA
  return (int)cudaErrorInvalidValue;
}
}  // namespace w4mma
