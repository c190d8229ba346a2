// Kernel 7: the W4X matmul for decode rows (B <= 32), y[B, n] = x @ W^T
// over a precise W4 fold with dual-plane int8 activations.  Two designs
// compute it, chosen by the wrapper's row threshold T
// (ops/cuda/qmm_w4x.py::MMA_MIN_ROWS, 1 on the H100): the warp-per-row
// walk below for one row, and int8 tensor cores (w4_mma.cuh) above it.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4 as the W4X
// dispatch reaches it (entry qmm_w4_matmul, precise branch): the Pallas
// kernel takes the 2B stacked activation planes of quantize_activations_2p
// as block-diagonal rows, its f32 scale planes scw_lo/scw_hi and the
// in-kernel min term (madj_t, or 8*scw_lo for sym folds), and the caller
// sums the two halves of its [2B, n] output.  Here the inputs are the
// dual-plane prologue's x8/sx/xsum (q8.cu, 2B rows) and the fold's f32
// g_scale/g_min [n, G] (s_eff and m_adj, never bf16-rounded; sym folds
// carry m_adj = 8 s_eff on lo groups in g_min like legacy ones):
//
//   y[b] = sum_{p=0,1} sum_g sx[pB+b, s] * (s_g * P_g(pB+b) - m_g * xsum[pB+b, g])
//
// with w = q * s_g - m_g on the raw codes (w4_dot.cuh).
//
// Bound on the H100: bytes.  The weight stream is 4 bits of codes plus the
// f32 s_eff and m_adj per 32-group, 6 bits per weight; at B <= 32 a weight
// byte feeds at most 2 * 2 * 32 int8 operations, far below the card's ~590
// per byte of memory bandwidth.  Design: kernel 1's (one warp per output
// row, 8 rows per block, 512-byte warp loads, no shared memory) with both
// activation planes walked against each 16-byte code load while its
// nibbles sit unpacked in registers, and accumulated into the same
// registers: every weight byte is read once for both planes, and no
// [2B, n] intermediate is written.
//
// The walk re-reads 2 x 16 bytes of activations for each of the 2B
// (row, plane) pairs against every 16-byte code load, so past a few rows
// it is bound by activation traffic and __dp4a issue, not by the weight
// stream (gate|up at B = 32: 42x its bound).  Above T the 2B plane rows
// are the A operand of mma.sync m16n8k32 s8 (one 32-group a product, exact
// int32 partials) staged once a span in shared memory for the block's 8
// warps, the weight codes the B operand, unpacked to int8 in registers;
// split K fills the card at n = 4096 and 6144.  T is the crossover
// measured on the card (PERF.md, kernel 7 rows).
#include "w4_dot.cuh"
#include "w4_mma.cuh"

// The walk takes one row (the wrapper sends more to the tensor cores).
__global__ void __launch_bounds__(256)
w4x_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                const int* __restrict__ xsum, const uint8_t* __restrict__ codes,
                const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc,
                float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  float acc[1] = {0.f};
  w4_row_partial<1, false, 2>(acc, x8, sx, xsum, 1, codes, nullptr, nullptr, gs, gm, row, kc,
                              lane);
  const float v = warp_sum(acc[0]);
  if (lane == 0) y[row] = v;
}

// x8 [2B, 2kc] int8, sx [2B, kc/128] f32, xsum [2B, kc/16] int32 (plane 1
// in rows 0..B-1, plane 2 in rows B..2B-1); codes [n, kc] u8; gs, gm
// [n, kc/16] f32; y [B, n] f32.  kc % 512 == 0.  splits == 0 runs the
// walk (B == 1 only); splits >= 1 the tensor-core GEMM with K split in
// that many span ranges (ops/cuda/qmm.py::plan), with ws [splits, B, n]
// f32 and cnt (one zeroed int a 128-column tile) when splits > 1.
LK_API int lk_w4x_gemv(const int8_t* x8, const float* sx, const int* xsum, int B,
                       const uint8_t* codes, const float* gs, const float* gm, int n, int kc,
                       float* y, int splits, float* ws, int* cnt, cudaStream_t stream) {
  if (n <= 0 || kc <= 0 || kc % 512 || B < 1 || B > 32 || splits < 0 || splits > kc / 128 ||
      (splits == 0 && B > 1) || (splits > 1 && (!ws || !cnt || n % 4)))
    return (int)cudaErrorInvalidValue;
  if (splits >= 1)
    return w4mma::launch<2>(x8, sx, xsum, B, codes, gs, gm, n, kc, y, splits, ws, cnt, stream);
  w4x_gemv_kernel<<<(n + 7) / 8, 256, 0, stream>>>(x8, sx, xsum, codes, gs, gm, n, kc, y);
  return (int)cudaGetLastError();
}
