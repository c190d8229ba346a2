// The two steps of the gated FFN after gate|up, shared by qmm_w4_ffn.cu
// (kernel 2) and qmm_w4_layer.cu (kernel 10).  Both work on one 256-wide
// superblock f of F at a time:
//   ffn_quantize_h: h = bf16(act(g) * u), rounded to bf16 as the JAX kernel
//     does before re-quantizing, then quantized per row over the
//     superblock (one warp per batch row) into shared h8/dh/hsum;
//   ffn_down_partial: the down product of down rows [e_lo, e_hi) over the
//     superblock's 128 plane bytes (8 lanes a row, 4 rows a warp step, so
//     e_hi - e_lo must be a multiple of 4 * nwarps), written to
//     partial[f][b][e]; SYM as in w4_dot.cuh (dn_gm is not read).
#pragma once

#include "w4_dot.cuh"

constexpr float kGeluC = 0.79788456080286535587989211986876f;

// g and u point at element 256 f of batch row 0; row b is `stride` further.
__device__ __forceinline__ void ffn_quantize_h(int B, const float* g, const float* u,
                                               size_t stride, int act, int8_t* h8, float* dh,
                                               int* hsum, int warp, int nwarps, int lane) {
  for (int b = warp; b < B; b += nwarps) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane * 8 + i;
      const float gv = g[b * stride + c], uv = u[b * stride + c];
      const float a = act == 0 ? gv * (1.f / (1.f + expf(-gv)))
                               : 0.5f * gv * (1.f + tanhf(kGeluC * gv * (1.f + 0.044715f * gv * gv)));
      v[i] = __bfloat162float(__float2bfloat16_rn(a * uv));
    }
    __align__(8) int8_t q[8];
    int gsum;
    const float d = quantize8_sb(v, q, &gsum);
    *reinterpret_cast<int2*>(h8 + b * 256 + lane * 8) = *reinterpret_cast<const int2*>(q);
    if ((lane & 3) == 0) hsum[b * 8 + lane / 4] = gsum;
    if (lane == 0) dh[b] = d;
  }
}

template <int NB, bool COMPACT, bool SYM = false>
__device__ __forceinline__ void ffn_down_partial(
    const int8_t* __restrict__ h8, const float* __restrict__ dh, const int* __restrict__ hsum,
    int B, const uint8_t* __restrict__ dn_codes, const uint8_t* __restrict__ dn_q6,
    const float* __restrict__ dn_dd, const float* __restrict__ dn_gs,
    const float* __restrict__ dn_gm, int E, int F, int f, int e_lo, int e_hi, int warp,
    int nwarps, int lane, float* __restrict__ partial) {
  const int S_F = F / 256, G_F = F / 32;
  const int part = lane & 7, j0 = part * 16, jg = j0 >> 5;
  const bool lead = (part & 1) == 0;
  for (int e = e_lo + warp * 4 + (lane >> 3); e < e_hi; e += 4 * nwarps) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(dn_codes + (size_t)e * (F / 2) +
                                                         f * 128 + j0));
    float s_lo, s_hi, m_lo, m_hi;
    if (COMPACT) {
      const size_t sb = (size_t)e * S_F + f;
      const uint8_t* q = dn_q6 + sb * 16;
      const float d = __ldg(dn_dd + 2 * sb), dmin = __ldg(dn_dd + 2 * sb + 1);
      s_lo = d * (float)q[jg];
      s_hi = d * (float)q[4 + jg];
      m_lo = dmin * (float)q[8 + jg];
      m_hi = dmin * (float)q[12 + jg];
    } else {
      const size_t g = (size_t)e * G_F + f * 8;
      s_lo = __ldg(dn_gs + g + jg);
      s_hi = __ldg(dn_gs + g + jg + 4);
      m_lo = SYM ? 8.f * s_lo : __ldg(dn_gm + g + jg);
      m_hi = (SYM ? 0.f : __ldg(dn_gm + g + jg + 4)) + 8.f * s_hi;
    }
    const unsigned wv[4] = {w.x, w.y, w.z, w.w};
    int lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = (int)(wv[i] & 0x0F0F0F0Fu);
      hi[i] = (int)(((wv[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
    }
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      acc[b] = 0.f;
      if (b < B) {
        const int4 hl = *reinterpret_cast<const int4*>(h8 + b * 256 + j0);
        const int4 hh = *reinterpret_cast<const int4*>(h8 + b * 256 + 128 + j0);
        int pl = __dp4a(lo[0], hl.x, 0);
        pl = __dp4a(lo[1], hl.y, pl);
        pl = __dp4a(lo[2], hl.z, pl);
        pl = __dp4a(lo[3], hl.w, pl);
        int ph = __dp4a(hi[0], hh.x, 0);
        ph = __dp4a(hi[1], hh.y, ph);
        ph = __dp4a(hi[2], hh.z, ph);
        ph = __dp4a(hi[3], hh.w, ph);
        float t = s_lo * (float)pl + s_hi * (float)ph;
        if (lead) t -= m_lo * (float)hsum[b * 8 + jg] + m_hi * (float)hsum[b * 8 + jg + 4];
        acc[b] = dh[b] * t;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float v = acc[b];
      v += __shfl_xor_sync(LK_FULL_MASK, v, 1);
      v += __shfl_xor_sync(LK_FULL_MASK, v, 2);
      v += __shfl_xor_sync(LK_FULL_MASK, v, 4);
      if (part == 0 && b < B) partial[((size_t)f * B + b) * E + e] = v;
    }
  }
}
