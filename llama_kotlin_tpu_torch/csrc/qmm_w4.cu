// Kernel 1: W4A8 matmul for decode rows (B <= 32), y[B, n] = x @ W^T.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4_fx2 (entry
// qmm_w4_matmul).  Inputs are the prologue's x8/sx/xsum (q8.cu) and one W4
// fold (compact, sym or legacy):
//
//   y[b] = sum_g sx[b, s] * (s_g * P_g(b) - m_g * xsum[b, g])
//
// with P_g the exact integer partial of 32-group g and w = q s_g - m_g
// (w4_dot.cuh).  Compact folds form s_g = d sc6 and m_g = dmin m6 from
// their streamed 6-bit codes; sym folds m_g = 8 s_g from the scale, so
// neither reads an f32 min plane.
//
// Bound on the H100: bytes.  At B <= 32 every weight byte feeds at most
// 2*32 int8 operations, far below the card's ~590 int8 ops per byte of
// memory bandwidth, so the time floor is the weight stream (4.625 bits per
// weight for compact folds, 5 for sym ones).  Two designs compute it,
// chosen by the wrapper's row threshold T1 (ops/cuda/qmm_w4.py::
// MMA_MIN_ROWS, W4_WALK_ROWS here):
//
// - up to T1 rows, the walk: one warp per output row so each row's codes
//   stream as contiguous 512-byte warp loads, 8 rows per block, no shared
//   memory or block synchronisation; the batch rows reuse each 16-byte code
//   load from registers.  Past a few rows it is bound by the activation
//   traffic (each lane re-reads 32 bytes of every row against each code
//   load) and __dp4a issue, not by the weights.
// - above T1, kernel 7's int8 tensor-core tile with one plane
//   (w4_mma.cuh::w4_mma_kernel with NP = 1): a block takes 128 weight rows and a K
//   range of whole spans (split K as ops/cuda/qmm.py::plan says, summed in
//   split order by the last block), the prologue's activation rows staged
//   once a span for the block's 8 warps; one mma.sync m16n8k32 is one
//   32-group, exact int32 partials.  A compact fold's span carries its 16
//   q6 codes and (d, dmin) into the stage (24 bytes a row, where the f32
//   planes take 64), a sym fold its scales only.
#include "w4_dot.cuh"
#include "w4_mma.cuh"

// T1: the walk takes at most this many rows (the wrapper's MMA_MIN_ROWS).
constexpr int W4_WALK_ROWS = 4;

template <int NB, bool COMPACT, bool SYM>
__global__ void __launch_bounds__(256)
w4_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
               const int* __restrict__ xsum, int B, const uint8_t* __restrict__ codes,
               const uint8_t* __restrict__ q6, const float* __restrict__ dd,
               const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc,
               float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  w4_row_partial<NB, COMPACT, 1, SYM>(acc, x8, sx, xsum, B, codes, q6, dd, gs, gm, row, kc,
                                      lane);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0 && b < B) y[(size_t)b * n + row] = v;
  }
}

// The walk's instances: one for each batch-row bucket up to T1.
template <bool COMPACT, bool SYM>
static int walk(const int8_t* x8, const float* sx, const int* xsum, int B, const uint8_t* codes,
                const uint8_t* q6, const float* dd, const float* gs, const float* gm, int n,
                int kc, float* y, cudaStream_t stream) {
  static_assert(W4_WALK_ROWS == 4, "the walk's instances are those up to T1");
  const dim3 grid((n + 7) / 8), block(256);
  if (B == 1)
    w4_gemv_kernel<1, COMPACT, SYM><<<grid, block, 0, stream>>>(x8, sx, xsum, B, codes, q6, dd,
                                                                gs, gm, n, kc, y);
  else if (B == 2)
    w4_gemv_kernel<2, COMPACT, SYM><<<grid, block, 0, stream>>>(x8, sx, xsum, B, codes, q6, dd,
                                                                gs, gm, n, kc, y);
  else
    w4_gemv_kernel<4, COMPACT, SYM><<<grid, block, 0, stream>>>(x8, sx, xsum, B, codes, q6, dd,
                                                                gs, gm, n, kc, y);
  return (int)cudaGetLastError();
}

// x8 [B, 2 kc] int8, sx [B, kc/128] f32, xsum [B, kc/16] int32 (q8.cu);
// codes [n, kc] u8; compact != 0: q6 [n, kc/128, 16] u8 and dd
// [n, kc/128, 2] f32 (gs, gm not read); else gs [n, kc/16] f32 and, unless
// sym != 0, gm [n, kc/16] f32; y [B, n] f32.  kc % 512 == 0, 1 <= B <= 32.
// splits == 0 runs the walk (B <= T1 only); splits >= 1 the tensor-core
// GEMM with K split in that many span ranges, with ws [splits, B, n] f32
// and cnt (one zeroed int a 128-column tile) when splits > 1.
LK_API int lk_w4_gemv(const int8_t* x8, const float* sx, const int* xsum, int B,
                      const uint8_t* codes, const uint8_t* q6, const float* dd,
                      const float* gs, const float* gm, int n, int kc, int compact, int sym,
                      float* y, int splits, float* ws, int* cnt, cudaStream_t stream) {
  if (n <= 0 || kc <= 0 || kc % 512 || B < 1 || B > 32 || (compact && sym) ||
      (compact ? (!q6 || !dd) : (!gs || (!sym && !gm))) || splits < 0 || splits > kc / 128 ||
      (splits == 0 && B > W4_WALK_ROWS) || (splits > 1 && (!ws || !cnt || n % 4)))
    return (int)cudaErrorInvalidValue;
  if (splits >= 1) {
    if (compact)
      return w4mma::launch<1, false, true>(x8, sx, xsum, B, codes, gs, gm, n, kc, y, splits, ws,
                                           cnt, stream, q6, dd);
    return sym ? w4mma::launch<1, true>(x8, sx, xsum, B, codes, gs, gm, n, kc, y, splits, ws,
                                        cnt, stream)
               : w4mma::launch<1>(x8, sx, xsum, B, codes, gs, gm, n, kc, y, splits, ws, cnt,
                                  stream);
  }
  if (compact) return walk<true, false>(x8, sx, xsum, B, codes, q6, dd, gs, gm, n, kc, y, stream);
  return sym ? walk<false, true>(x8, sx, xsum, B, codes, q6, dd, gs, gm, n, kc, y, stream)
             : walk<false, false>(x8, sx, xsum, B, codes, q6, dd, gs, gm, n, kc, y, stream);
}
