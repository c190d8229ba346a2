// One lane's share of a W4A8 row dot, shared by qmm_w4.cu (kernel 1),
// qmm_w4_ffn.cu (kernel 2), qmm_w4x.cu (kernel 7), qmm_w4_fx.cu (kernel 8)
// and qmm_w4_layer.cu (kernel 10).
//
// Row `row` of a W4 fold holds kc = k/2 plane-packed bytes: byte j of span
// s carries element 256s+j in its low nibble (raw code 0..15) and element
// 256s+128+j in its high nibble, stored as (q-8) & 0xF.  A warp sweeps the
// row 512 bytes at a time, 16 bytes per lane: those 16 bytes are half of
// lo group 8s + j/32 and half of hi group 8s + 4 + j/32, so a lane pair
// covers both groups whole.  Integer partials come from __dp4a on the raw
// codes (hi = nibble ^ 8), and the group scale and min apply in registers:
//
//   y[b] += sx[b, s] * (s_g * sum_c x8[b, c] q[c]  -  m_g * xsum[b, g])
//
// with w = q * s_g - m_g.  Compact folds form s_g = d * sc6 and
// m_g = dmin * m6 from the streamed 6-bit codes (exact f32 products, the
// wire's own dequant); legacy folds read s_g = g_scale and m_g = g_min
// (+ 8 s_g on hi groups, undoing the fold's nibble bias).  A sym fold's
// g_min is 8 s_g on lo groups and 0 on hi groups, so with SYM the walk
// forms m_g = 8 s_g (exact, the same f32 value) and never reads g_min.
// This replaces the TPU kernel's block-diagonal MXU layout: on Hopper the
// per-group partial is a handful of dp4a, so no row redundancy is needed.
//
// NP is the number of activation planes: 1 for W4A8 (kernels 1 and 2); 2
// for the W4X dual-plane activations (kernel 7), whose plane p of batch
// row b is row p*B + b of x8/sx/xsum.  Both planes take the same unpacked
// weight registers and add into the same acc[b], so the weights stream
// once and the plane sum happens here.
#pragma once

#include "common.cuh"

//
// w4_span_partial walks the plane bytes [c_begin, c_end) of the row only
// (c_begin a multiple of 512), against activations that hold just that
// span's columns: row rb of x8 starts at element 2*c_begin and has stride
// xk, with sx and xsum strided xk/256 and xk/32 (kernel 8 keeps one k-tile
// of quantized activations in shared memory).  w4_row_partial is the whole
// row against whole activation rows.
template <int NB, bool COMPACT, int NP = 1, bool SYM = false>
__device__ __forceinline__ void w4_span_partial(
    float acc[NB], const int8_t* __restrict__ x8, const float* __restrict__ sx,
    const int* __restrict__ xsum, int B, int xk, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ q6, const float* __restrict__ dd, const float* __restrict__ gs,
    const float* __restrict__ gm, int row, int kc, int c_begin, int c_end, int lane) {
  const int k = 2 * kc, G = k / 32, S = k / 256;
  const int XG = xk / 32, XS = xk / 256, s0 = c_begin >> 7;
  const uint8_t* crow = codes + (size_t)row * kc;
  const bool lead = (lane & 1) == 0;  // the lane pair's min term is added once
#pragma unroll 2
  for (int c0 = c_begin + lane * 16; c0 < c_end; c0 += 512) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(crow + c0));
    const int s = c0 >> 7, j = (c0 & 127) >> 5;
    const int gl = s * 8 + j, gh = gl + 4;
    float s_lo, s_hi, m_lo, m_hi;
    if (COMPACT) {
      const size_t sb = (size_t)row * S + s;
      const uint8_t* q = q6 + sb * 16;
      const float d = __ldg(dd + 2 * sb), dmin = __ldg(dd + 2 * sb + 1);
      s_lo = d * (float)q[j];
      s_hi = d * (float)q[4 + j];
      m_lo = dmin * (float)q[8 + j];
      m_hi = dmin * (float)q[12 + j];
    } else {
      const size_t g = (size_t)row * G;
      s_lo = __ldg(gs + g + gl);
      s_hi = __ldg(gs + g + gh);
      m_lo = SYM ? 8.f * s_lo : __ldg(gm + g + gl);
      m_hi = (SYM ? 0.f : __ldg(gm + g + gh)) + 8.f * s_hi;
    }
    const unsigned wv[4] = {w.x, w.y, w.z, w.w};
    int lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = (int)(wv[i] & 0x0F0F0F0Fu);
      hi[i] = (int)(((wv[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int rb = p * B + b;  // row of plane p
          const int8_t* xr = x8 + (size_t)rb * xk + (s - s0) * 256 + (c0 & 127);
          const int4 xl = *reinterpret_cast<const int4*>(xr);
          const int4 xh = *reinterpret_cast<const int4*>(xr + 128);
          int pl = __dp4a(lo[0], xl.x, 0);
          pl = __dp4a(lo[1], xl.y, pl);
          pl = __dp4a(lo[2], xl.z, pl);
          pl = __dp4a(lo[3], xl.w, pl);
          int ph = __dp4a(hi[0], xh.x, 0);
          ph = __dp4a(hi[1], xh.y, ph);
          ph = __dp4a(hi[2], xh.z, ph);
          ph = __dp4a(hi[3], xh.w, ph);
          float t = s_lo * (float)pl + s_hi * (float)ph;
          const int xg = rb * XG - 8 * s0;
          if (lead) t -= m_lo * (float)xsum[xg + gl] + m_hi * (float)xsum[xg + gh];
          acc[b] += sx[rb * XS + s - s0] * t;
        }
      }
    }
  }
}

template <int NB, bool COMPACT, int NP = 1, bool SYM = false>
__device__ __forceinline__ void w4_row_partial(
    float acc[NB], const int8_t* __restrict__ x8, const float* __restrict__ sx,
    const int* __restrict__ xsum, int B, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ q6, const float* __restrict__ dd, const float* __restrict__ gs,
    const float* __restrict__ gm, int row, int kc, int lane) {
  w4_span_partial<NB, COMPACT, NP, SYM>(acc, x8, sx, xsum, B, 2 * kc, codes, q6, dd, gs, gm, row, kc,
                                   0, kc, lane);
}

// Batch-row bucket of the kernels' NB template: the smallest of
// {1, 2, 4, 8, 16, 32} that holds B rows, or -1 when B is out of range.
__host__ __forceinline__ int nb_bucket(int B) {
  if (B < 1 || B > 32) return -1;
  int nb = 1;
  while (nb < B) nb <<= 1;
  return nb;
}

// Expands the statement(s) given after B with a constexpr int NB bound to nb_bucket(B).
#define LK_SWITCH_NB(B, ...)                  \
  switch (nb_bucket(B)) {                     \
    case 1: { constexpr int NB = 1; __VA_ARGS__; } break;   \
    case 2: { constexpr int NB = 2; __VA_ARGS__; } break;   \
    case 4: { constexpr int NB = 4; __VA_ARGS__; } break;   \
    case 8: { constexpr int NB = 8; __VA_ARGS__; } break;   \
    case 16: { constexpr int NB = 16; __VA_ARGS__; } break; \
    case 32: { constexpr int NB = 32; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;      \
  }
