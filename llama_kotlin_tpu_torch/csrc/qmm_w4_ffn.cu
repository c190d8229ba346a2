// Kernel 2: the gated FFN of a decode step in one pass over its weights,
// y[B, E] = (act(x Wg^T) * (x Wu^T)) Wd^T, B <= 32.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::qmm_w4_ffn (entry
// qmm_w4_ffn_matmul) for the fused [gate; up] layout: gu [2F, E] and
// down [E, F], both W4 folds of one flavor.  The activations arrive as the
// prologue's x8/sx/xsum (q8.cu).
//
// Bound on the H100: bytes (the 3*E*F weights at <= 64 int8 ops a byte).
// Design: the F axis is elementwise in the gated FFN, so each block owns
// one 256-wide superblock of F and does the whole FFN for it:
//   1. its 256 gate and 256 up rows (w4_row_partial, one warp per row) into
//      shared memory;
//   2. h = bf16(act(g) * u), rounded to bf16 as the JAX kernel does before
//      re-quantizing, then quantized per row over the block's superblock —
//      exactly the per-256 Q8 of h, so h never leaves shared memory;
//   3. the down product over the block's 128 plane bytes of every down row
//      (8 lanes per row), written as a [B, E] partial.
// A second kernel sums the F/256 partials in a fixed order, so the result
// is deterministic (no atomics) and greedy tokens repeat run to run.
#include "w4_dot.cuh"

constexpr float kGeluC = 0.79788456080286535587989211986876f;

template <int NB, bool COMPACT>
__global__ void __launch_bounds__(512)
w4_ffn_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
              const int* __restrict__ xsum, int B, const uint8_t* __restrict__ gu_codes,
              const uint8_t* __restrict__ gu_q6, const float* __restrict__ gu_dd,
              const float* __restrict__ gu_gs, const float* __restrict__ gu_gm,
              const uint8_t* __restrict__ dn_codes, const uint8_t* __restrict__ dn_q6,
              const float* __restrict__ dn_dd, const float* __restrict__ dn_gs,
              const float* __restrict__ dn_gm, int E, int F, int act,
              float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gu_s = reinterpret_cast<float*>(smem);                   // [NB][512]
  int8_t* h8 = reinterpret_cast<int8_t*>(gu_s + NB * 512);          // [NB][256]
  float* dh = reinterpret_cast<float*>(h8 + NB * 256);              // [NB]
  int* hsum = reinterpret_cast<int*>(dh + NB);                      // [NB][8]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x, f0 = blk * 256;

  // 1. gate rows f0.. and up rows F+f0.. of the fused tensor
  for (int r = warp; r < 512; r += 16) {
    const int row = r < 256 ? f0 + r : F + f0 + (r - 256);
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    w4_row_partial<NB, COMPACT>(acc, x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs, gu_gm,
                                row, E / 2, lane);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float v = warp_sum(acc[b]);
      if (lane == 0) gu_s[b * 512 + r] = v;
    }
  }
  __syncthreads();

  // 2. h in bf16, quantized per row of the batch (one warp per row)
  for (int b = warp; b < B; b += 16) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane * 8 + i;
      const float g = gu_s[b * 512 + c], u = gu_s[b * 512 + 256 + c];
      const float a = act == 0 ? g * (1.f / (1.f + expf(-g)))
                               : 0.5f * g * (1.f + tanhf(kGeluC * g * (1.f + 0.044715f * g * g)));
      v[i] = __bfloat162float(__float2bfloat16_rn(a * u));
    }
    __align__(8) int8_t q[8];
    int gsum;
    const float d = quantize8_sb(v, q, &gsum);
    *reinterpret_cast<int2*>(h8 + b * 256 + lane * 8) = *reinterpret_cast<const int2*>(q);
    if ((lane & 3) == 0) hsum[b * 8 + lane / 4] = gsum;
    if (lane == 0) dh[b] = d;
  }
  __syncthreads();

  // 3. down partial: 4 rows per warp step, 16 plane bytes per lane
  const int S_F = F / 256, G_F = F / 32;
  const int part = lane & 7, j0 = part * 16, jg = j0 >> 5;
  const bool lead = (part & 1) == 0;
  for (int e = warp * 4 + (lane >> 3); e < E; e += 64) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(dn_codes + (size_t)e * (F / 2) +
                                                         blk * 128 + j0));
    float s_lo, s_hi, m_lo, m_hi;
    if (COMPACT) {
      const size_t sb = (size_t)e * S_F + blk;
      const uint8_t* q = dn_q6 + sb * 16;
      const float d = __ldg(dn_dd + 2 * sb), dmin = __ldg(dn_dd + 2 * sb + 1);
      s_lo = d * (float)q[jg];
      s_hi = d * (float)q[4 + jg];
      m_lo = dmin * (float)q[8 + jg];
      m_hi = dmin * (float)q[12 + jg];
    } else {
      const size_t g = (size_t)e * G_F + blk * 8;
      s_lo = __ldg(dn_gs + g + jg);
      s_hi = __ldg(dn_gs + g + jg + 4);
      m_lo = __ldg(dn_gm + g + jg);
      m_hi = __ldg(dn_gm + g + jg + 4) + 8.f * s_hi;
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
      if (part == 0 && b < B) partial[((size_t)blk * B + b) * E + e] = v;
    }
  }
}

// Fixed-order sum of the per-block partials: y[i] = sum_blk partial[blk][i].
__global__ void ffn_reduce_kernel(const float* __restrict__ partial, float* __restrict__ y,
                                  int nblk, int be) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= be) return;
  float s = 0.f;
  for (int blk = 0; blk < nblk; ++blk) s += partial[(size_t)blk * be + i];
  y[i] = s;
}

template <int NB, bool COMPACT>
static int launch_ffn(const int8_t* x8, const float* sx, const int* xsum, int B,
                      const uint8_t* gu_codes, const uint8_t* gu_q6, const float* gu_dd,
                      const float* gu_gs, const float* gu_gm, const uint8_t* dn_codes,
                      const uint8_t* dn_q6, const float* dn_dd, const float* dn_gs,
                      const float* dn_gm, int E, int F, int act, float* partial,
                      cudaStream_t stream) {
  const size_t smem = (size_t)NB * (512 * 4 + 256 + 4 + 8 * 4);
  auto kern = w4_ffn_kernel<NB, COMPACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<F / 256, 512, smem, stream>>>(x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs, gu_gm,
                                       dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E, F, act,
                                       partial);
  return (int)cudaGetLastError();
}

// partial: scratch [F/256, B, E] f32; y: [B, E] f32.
LK_API int lk_w4_ffn(const int8_t* x8, const float* sx, const int* xsum, int B,
                     const uint8_t* gu_codes, const uint8_t* gu_q6, const float* gu_dd,
                     const float* gu_gs, const float* gu_gm, const uint8_t* dn_codes,
                     const uint8_t* dn_q6, const float* dn_dd, const float* dn_gs,
                     const float* dn_gm, int E, int F, int compact, int act, float* partial,
                     float* y, cudaStream_t stream) {
  if (E <= 0 || E % 1024 || F <= 0 || F % 256 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  int err;
  if (compact) {
    LK_SWITCH_NB(B, err = launch_ffn<NB, true>(x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs,
                                              gu_gm, dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E,
                                              F, act, partial, stream))
  } else {
    LK_SWITCH_NB(B, err = launch_ffn<NB, false>(x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs,
                                               gu_gm, dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E,
                                               F, act, partial, stream))
  }
  if (err) return err;
  const int be = B * E;
  ffn_reduce_kernel<<<(be + 255) / 256, 256, 0, stream>>>(partial, y, F / 256, be);
  return (int)cudaGetLastError();
}
