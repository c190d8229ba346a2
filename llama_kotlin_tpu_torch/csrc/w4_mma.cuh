// The W4A8 product on int8 tensor cores, for row counts where the
// warp-per-row walk of w4_dot.cuh spends its time on activation traffic
// (kernel 7 above its row threshold, qmm_w4x.cu; kernels 1 and 8 above
// theirs, qmm_w4.cu and qmm_w4_fx.cu, with one plane).  NP activation planes of
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
//
// SYM (a sym fold: g_min is 8 s_g on lo groups and 0 on hi groups) forms
// m_g = 8 s_g from the scale, the same f32 value, and never copies g_min.
// COMPACT (a compact fold, kernel 1) copies each row's
// 16 six-bit codes of the span (8 scale codes, 8 min codes) and its f32
// (d, dmin) into the stage in place of the 8 f32 scales and 8 mins, 24
// bytes a row and span instead of 64, and forms s_g = d sc6 and
// m_g = dmin m6 where the scales apply: the exact f32 products that
// w4_dot.cuh's walk and the plain group_scale_min form.  A compact fold's
// hi codes are raw (nibble ^ 8), so its m_g takes no 8 s_g.
// Kernel 8 (w4_fx_mma_kernel) takes raw f32 rows: each span's activation
// slots are filled inside the block, each warp quantizing its rows with
// quantize8_sb's steps (the prologue's codes, bit for bit), from f32 loads
// issued before the span that is multiplied meanwhile.
#pragma once

#include "mma_pipe.cuh"

namespace w4mma {
constexpr int THREADS = 256, BN = 128, STAGES = 4;  // 8 warps of 16 weight rows
constexpr int C_LD = 160;  // bytes a code row (128 + 32: conflict-free 8-byte loads)
constexpr int S_LD = 12;   // floats a scale/min row (8 + 4)
constexpr int X_LD = 288;  // bytes an activation row (256 + 32)
constexpr int XS_LD = 12;  // ints an xsum row (8 + 4)

template <int MT, bool COMPACT = false>
struct Tile {
  static constexpr int MP = 16 * MT;
  static constexpr int C_BYTES = BN * C_LD, S_BYTES = BN * S_LD * 4;
  // the span's scales: f32 scale and min planes, or the compact q6 codes
  // (16 bytes a row) followed by the (d, dmin) pairs (8 bytes a row)
  static constexpr int W_BYTES = COMPACT ? BN * 16 + BN * 8 : 2 * S_BYTES;
  static constexpr int X_OFF = C_BYTES + W_BYTES;  // the activation rows
  static constexpr int X_BYTES = MP * X_LD, XS_BYTES = MP * XS_LD * 4, SX_BYTES = MP * 4;
  static constexpr int STAGE = X_OFF + X_BYTES + XS_BYTES + SX_BYTES;
  static constexpr int SMEM = STAGE * STAGES;
};

// Copies of span s of the weight rows into stage st: rows >= n are
// zero-filled; SYM copies no mins; COMPACT copies q6 [n, kc/128, 16] and
// dd [n, kc/128, 2] in place of the gs/gm planes.  GATED (kernel 2's
// gate|up tile): the tile's rows 0..63 are rows n0/2 .. n0/2 + 63 of this
// fold (gate) and its rows 64..127 the same rows of *up.
template <int MT, bool SYM = false, bool COMPACT = false, bool GATED = false>
__device__ __forceinline__ void load_weights(uint8_t* st, int s, const uint8_t* __restrict__ codes,
                                             const float* __restrict__ gs,
                                             const float* __restrict__ gm, int n, int kc,
                                             int n0, const uint8_t* __restrict__ q6 = nullptr,
                                             const float* __restrict__ dd = nullptr,
                                             const W4Fold* up = nullptr) {
  using T = Tile<MT, COMPACT>;
  const int tid = threadIdx.x, G = kc / 16;
  // the source row of tile row r, and whether it is up's
  auto row_of = [&](int r) { return GATED ? (n0 >> 1) + (r & (BN / 2 - 1)) : n0 + r; };
  auto is_up = [&](int r) { return GATED && r >= BN / 2; };
  for (int idx = tid; idx < BN * 8; idx += THREADS) {
    const int r = idx >> 3, c = idx & 7, row = row_of(r);
    const bool ok = row < n;
    const uint8_t* src = is_up(r) ? up->codes : codes;
    cp_async16(st + r * C_LD + c * 16, src + (size_t)(ok ? row : 0) * kc + s * 128 + c * 16,
               ok ? 16 : 0);
  }
  if (COMPACT) {
    uint8_t* qs = st + T::C_BYTES;
    float* ds = reinterpret_cast<float*>(qs + BN * 16);
    for (int idx = tid; idx < BN * 2; idx += THREADS) {
      const int r = idx >> 1, row = row_of(r);
      const bool ok = row < n;
      const size_t sb = (size_t)(ok ? row : 0) * (kc / 128) + s;
      if (idx & 1)
        cp_async8(ds + r * 2, (is_up(r) ? up->dd : dd) + 2 * sb, ok ? 8 : 0);
      else
        cp_async16(qs + r * 16, (is_up(r) ? up->q6 : q6) + 16 * sb, ok ? 16 : 0);
    }
    return;
  }
  float* ss = reinterpret_cast<float*>(st + T::C_BYTES);
  float* ms = ss + BN * S_LD;
  for (int idx = tid; idx < BN * 2; idx += THREADS) {
    const int r = idx >> 1, c = idx & 1, row = row_of(r);
    const bool ok = row < n;
    const size_t g = (size_t)(ok ? row : 0) * G + s * 8 + c * 4;
    cp_async16(ss + r * S_LD + c * 4, (is_up(r) ? up->gs : gs) + g, ok ? 16 : 0);
    if (!SYM) cp_async16(ms + r * S_LD + c * 4, (is_up(r) ? up->gm : gm) + g, ok ? 16 : 0);
  }
}

// Copies of span s of the activation rows into stage st: rows >= rows_live
// are zero-filled.
template <int MT, bool COMPACT = false>
__device__ __forceinline__ void load_acts(uint8_t* st, int s, const int8_t* __restrict__ x8,
                                          const float* __restrict__ sx,
                                          const int* __restrict__ xsum, int rows_live, int kc) {
  using T = Tile<MT, COMPACT>;
  const int tid = threadIdx.x, G = kc / 16, S = kc / 128;
  uint8_t* xs = st + T::X_OFF;
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

// Copies of span s into stage st: rows >= rows_live of the activations
// and >= n of the weights are zero-filled.
template <int MT, bool SYM = false, bool COMPACT = false>
__device__ __forceinline__ void load_span(uint8_t* st, int s, const int8_t* __restrict__ x8,
                                          const float* __restrict__ sx,
                                          const int* __restrict__ xsum, int rows_live,
                                          const uint8_t* __restrict__ codes,
                                          const float* __restrict__ gs,
                                          const float* __restrict__ gm, int n, int kc, int n0,
                                          const uint8_t* __restrict__ q6 = nullptr,
                                          const float* __restrict__ dd = nullptr) {
  load_weights<MT, SYM, COMPACT>(st, s, codes, gs, gm, n, kc, n0, q6, dd);
  load_acts<MT, COMPACT>(st, s, x8, sx, xsum, rows_live, kc);
}

// One span's products and scaling into acc[mt][nt][e] (activation row
// mt*16 + g (+8 for e >= 2), weight row warp*16 + 8 nt + 2t + (e & 1)).
template <int MT, bool SYM = false, bool COMPACT = false>
__device__ __forceinline__ void span_step(const uint8_t* st, float acc[MT][2][4], int warp,
                                          int g, int t) {
  using T = Tile<MT, COMPACT>;
  const uint8_t* cs = st;
  const float* ss = reinterpret_cast<const float*>(st + T::C_BYTES);
  const float* ms = ss + BN * S_LD;
  const uint8_t* xs = st + T::X_OFF;
  const int* xss = reinterpret_cast<const int*>(xs + T::X_BYTES);
  const float* sxs = reinterpret_cast<const float*>(xss + T::MP * XS_LD);
  float sxr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    sxr[mt][0] = sxs[mt * 16 + g];
    sxr[mt][1] = sxs[mt * 16 + g + 8];
  }
  // COMPACT: the 16 q6 bytes (scale codes of groups 0..3 | 4..7, min codes
  // of groups 0..3 | 4..7), (d, dmin) and (-2^23 d, -2^23 dmin) of this
  // thread's weight rows
  uint4 q6r[2][2];
  float2 ddr[2][2], ddn[2][2];
  if (COMPACT) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = warp * 16 + nt * 8 + 2 * t + j;
        q6r[nt][j] = *reinterpret_cast<const uint4*>(st + T::C_BYTES + col * 16);
        ddr[nt][j] = *reinterpret_cast<const float2*>(st + T::C_BYTES + BN * 16 + col * 8);
        ddn[nt][j] = make_float2(-8388608.f * ddr[nt][j].x, -8388608.f * ddr[nt][j].y);
      }
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
          if (COMPACT) {  // scale code gi: byte gp of word h; min code: word 2 + h
            // d sc6 as (2^23 + sc6) d - 2^23 d in one FMA: the exact
            // product, rounded once, as d * sc6 (byte_f, no int-to-float
            // conversion, which runs at a quarter of the FMA rate)
            const uint4 q = q6r[nt][j];
            const uint32_t sw = h ? q.y : q.x, mw = h ? q.w : q.z;
            sc[nt][j] = __fmaf_rn(byte_f(sw, gp), ddr[nt][j].x, ddn[nt][j].x);
            mn[nt][j] = __fmaf_rn(byte_f(mw, gp), ddr[nt][j].y, ddn[nt][j].y);
            continue;
          }
          sc[nt][j] = ss[col * S_LD + gi];
          if (SYM) {
            mn[nt][j] = 8.f * sc[nt][j];  // 8 s on lo groups, 0 + 8 s on hi ones
          } else {
            mn[nt][j] = ms[col * S_LD + gi];
            if (h) mn[nt][j] += 8.f * sc[nt][j];
          }
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
// [n, kc/16] f32 (SYM: gm not read), or COMPACT q6 [n, kc/128, 16] u8 and
// dd [n, kc/128, 2] f32 in their place.  Grid (ceil(n / BN), 1, splits);
// ws [splits, B, n] f32 and cnt (one int a column tile, zero) when
// splits > 1.  Kernel 7 takes NP = 2 and neither flag; kernel 1 NP = 1.
template <int NP, int MT, bool SYM = false, bool COMPACT = false>
__global__ void __launch_bounds__(THREADS, 1)
w4_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
              const int* __restrict__ xsum, int B, const uint8_t* __restrict__ codes,
              const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc,
              float* __restrict__ y, int splits, float* __restrict__ ws, int* __restrict__ cnt,
              const uint8_t* __restrict__ q6, const float* __restrict__ dd) {
  using T = Tile<MT, COMPACT>;
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
      load_span<MT, SYM, COMPACT>(smem + i * T::STAGE, s0 + i, x8, sx, xsum, rows_live, codes,
                                  gs, gm, n, kc, n0, q6, dd);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ns)
      load_span<MT, SYM, COMPACT>(smem + (nxt % STAGES) * T::STAGE, s0 + nxt, x8, sx, xsum,
                                  rows_live, codes, gs, gm, n, kc, n0, q6, dd);
    cp_async_commit();
    span_step<MT, SYM, COMPACT>(smem + (i % STAGES) * T::STAGE, acc, warp, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();

  store_planes<NP, MT, BN, THREADS>(smem, acc, B, n, n0, warp, g, t, y, splits, ws, cnt, z);
}

// Kernel 8's activation rows of one span in registers: warp w holds rows
// w, w + 8, ... (< B), lane l elements 8l..8l+7 of the span.
template <int MT>
struct XSpan {
  float4 v[Tile<MT>::MP / 8][2];
};

template <int MT>
__device__ __forceinline__ void fetch_x(XSpan<MT>& r, const float* __restrict__ x, int B, int k,
                                        int s, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < Tile<MT>::MP / 8; ++i) {
    const int row = warp + 8 * i;
    r.v[i][0] = r.v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < B) {
      const float4* p = reinterpret_cast<const float4*>(x + (size_t)row * k + s * 256 + lane * 8);
      r.v[i][0] = __ldg(p);
      r.v[i][1] = __ldg(p + 1);
    }
  }
}

// The rows of r quantized into stage st's activation slots: codes, group
// sums and the superblock scale, as q8.cu's prologue computes them for span
// s (and, where x8_out is given, written in q8.cu's layout to global
// memory).  quantize8_sb's steps run over a warp's MP / 8 rows together,
// with div_nb's branch-free division, so the rows' chains overlap; rows
// >= B hold zeros and quantize to zero codes, sums and scales.
template <int MT>
__device__ __forceinline__ void quantize_span(uint8_t* st, const XSpan<MT>& r, int B, int k,
                                              int s, int warp, int lane,
                                              int8_t* __restrict__ x8_out,
                                              float* __restrict__ sx_out,
                                              int* __restrict__ xsum_out) {
  using T = Tile<MT>;
  constexpr int RW = T::MP / 8;
  uint8_t* xs = st + T::X_OFF;
  int* xss = reinterpret_cast<int*>(xs + T::X_BYTES);
  float* sxs = reinterpret_cast<float*>(xss + T::MP * XS_LD);
  float v[RW][8], d[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float4 a = r.v[i][0], c = r.v[i][1];
    v[i][0] = a.x, v[i][1] = a.y, v[i][2] = a.z, v[i][3] = a.w;
    v[i][4] = c.x, v[i][5] = c.y, v[i][6] = c.z, v[i][7] = c.w;
    d[i] = sb_scale(v[i]);
  }
  __align__(8) int8_t q[RW][8];
  int gsum[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float safe = d[i] > 0.f ? d[i] : 1.0f;
    const float scale = norm_scale(safe), dn = __fmul_rn(safe, scale), y = recip_nb(dn);
    gsum[i] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = code8(div_nb(__fmul_rn(v[i][j], scale), dn, y));
      q[i][j] = (int8_t)c;
      gsum[i] += c;
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) gsum[i] = group_sum(gsum[i]);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = warp + 8 * i;
    const int2 q2 = *reinterpret_cast<const int2*>(q[i]);
    *reinterpret_cast<int2*>(xs + row * X_LD + lane * 8) = q2;
    if ((lane & 3) == 0) xss[row * XS_LD + lane / 4] = gsum[i];
    if (lane == 0) sxs[row] = d[i];
    if (x8_out && row < B) {
      *reinterpret_cast<int2*>(x8_out + (size_t)row * k + s * 256 + lane * 8) = q2;
      if ((lane & 3) == 0) xsum_out[(size_t)row * (k / 32) + s * 8 + lane / 4] = gsum[i];
      if (lane == 0) sx_out[(size_t)row * (k / 256) + s] = d[i];
    }
  }
}

// Kernel 8 above its row threshold: y [B, n] = W4A8(x) W^T for raw f32 x
// [B, 2 kc], B <= 32; codes [n, kc] u8, gs (and, unless SYM, gm) [n, kc/16]
// f32.  As w4_mma_kernel with one plane, but each span's activation slots
// are quantized here: the f32 rows of the span STAGES - 1 ahead are loaded
// before this span's products and quantized after them.  Where x8_out is
// given, the blocks of the first column tile also write their codes,
// scales and group sums in q8.cu's layout (a check of the quantizer).
template <int MT, bool SYM>
__global__ void __launch_bounds__(THREADS, 1)
w4_fx_mma_kernel(const float* __restrict__ x, int B, const uint8_t* __restrict__ codes,
                 const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc,
                 float* __restrict__ y, int splits, float* __restrict__ ws,
                 int* __restrict__ cnt, int8_t* __restrict__ x8_out, float* __restrict__ sx_out,
                 int* __restrict__ xsum_out) {
  using T = Tile<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, z = blockIdx.z, k = 2 * kc;
  int s0, s1;
  split_range(z, splits, kc / 128, &s0, &s1);
  const int ns = s1 - s0;
  if (blockIdx.x != 0) x8_out = nullptr;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  XSpan<MT> xr;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) {
      load_weights<MT, SYM>(smem + i * T::STAGE, s0 + i, codes, gs, gm, n, kc, n0);
      fetch_x(xr, x, B, k, s0 + i, warp, lane);
      quantize_span(smem + i * T::STAGE, xr, B, k, s0 + i, warp, lane, x8_out, sx_out,
                    xsum_out);
    }
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    uint8_t* st_nxt = smem + (nxt % STAGES) * T::STAGE;
    if (nxt < ns) {
      fetch_x(xr, x, B, k, s0 + nxt, warp, lane);
      load_weights<MT, SYM>(st_nxt, s0 + nxt, codes, gs, gm, n, kc, n0);
    }
    cp_async_commit();
    span_step<MT, SYM>(smem + (i % STAGES) * T::STAGE, acc, warp, g, t);
    // stage nxt was last read by span i - 1, before this iteration's barrier
    if (nxt < ns)
      quantize_span(st_nxt, xr, B, k, s0 + nxt, warp, lane, x8_out, sx_out, xsum_out);
  }
  cp_async_wait<0>();
  __syncthreads();
  store_planes<1, MT, BN, THREADS>(smem, acc, B, n, n0, warp, g, t, y, splits, ws, cnt, z);
}

// Kernel 8's launch: MT = 1 up to 16 rows, else 2.
template <bool SYM>
inline int launch_fx(const float* x, int B, const uint8_t* codes, const float* gs,
                     const float* gm, int n, int kc, float* y, int splits, float* ws, int* cnt,
                     int8_t* x8_out, float* sx_out, int* xsum_out, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, 1, splits);
  if (B <= 16)
    LK_MMA_LAUNCH((w4_fx_mma_kernel<1, SYM>), Tile<1>::SMEM, grid, stream, x, B, codes, gs, gm,
                  n, kc, y, splits, ws, cnt, x8_out, sx_out, xsum_out)
  if (B <= 32)
    LK_MMA_LAUNCH((w4_fx_mma_kernel<2, SYM>), Tile<2>::SMEM, grid, stream, x, B, codes, gs, gm,
                  n, kc, y, splits, ws, cnt, x8_out, sx_out, xsum_out)
  return (int)cudaErrorInvalidValue;
}

// Launch with MT the smallest m16 count that holds NP B rows (kernel 1:
// NP = 1, B <= 32; kernel 7: NP = 2).
template <int NP, bool SYM = false, bool COMPACT = false>
inline int launch(const int8_t* x8, const float* sx, const int* xsum, int B,
                  const uint8_t* codes, const float* gs, const float* gm, int n, int kc,
                  float* y, int splits, float* ws, int* cnt, cudaStream_t stream,
                  const uint8_t* q6 = nullptr, const float* dd = nullptr) {
  using K1 = Tile<1, COMPACT>;
  using K2 = Tile<2, COMPACT>;
  const int rows = NP * B;
  const dim3 grid((n + BN - 1) / BN, 1, splits);
  if (rows <= 16)
    LK_MMA_LAUNCH((w4_mma_kernel<NP, 1, SYM, COMPACT>), K1::SMEM, grid, stream, x8, sx, xsum, B,
                  codes, gs, gm, n, kc, y, splits, ws, cnt, q6, dd)
  if (rows <= 32)
    LK_MMA_LAUNCH((w4_mma_kernel<NP, 2, SYM, COMPACT>), K2::SMEM, grid, stream, x8, sx, xsum, B,
                  codes, gs, gm, n, kc, y, splits, ws, cnt, q6, dd)
  if constexpr (NP > 1) {  // one plane holds at most 32 rows
    using K4 = Tile<4, COMPACT>;
    if (rows <= 64)
      LK_MMA_LAUNCH((w4_mma_kernel<NP, 4, SYM, COMPACT>), K4::SMEM, grid, stream, x8, sx, xsum,
                    B, codes, gs, gm, n, kc, y, splits, ws, cnt, q6, dd)
  }
  return (int)cudaErrorInvalidValue;
}
}  // namespace w4mma
