// Kernel 7: the W4X matmul for decode rows (B <= 32), y[B, n] = x @ W^T
// over a precise W4 fold with dual-plane int8 activations.
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
#include "w4_dot.cuh"

template <int NB>
__global__ void __launch_bounds__(256)
w4x_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                const int* __restrict__ xsum, int B, const uint8_t* __restrict__ codes,
                const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc,
                float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  w4_row_partial<NB, false, 2>(acc, x8, sx, xsum, B, codes, nullptr, nullptr, gs, gm, row, kc,
                               lane);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0 && b < B) y[(size_t)b * n + row] = v;
  }
}

// x8 [2B, 2kc] int8, sx [2B, kc/128] f32, xsum [2B, kc/16] int32 (plane 1
// in rows 0..B-1, plane 2 in rows B..2B-1); codes [n, kc] u8; gs, gm
// [n, kc/16] f32; y [B, n] f32.  kc % 512 == 0.
LK_API int lk_w4x_gemv(const int8_t* x8, const float* sx, const int* xsum, int B,
                       const uint8_t* codes, const float* gs, const float* gm, int n, int kc,
                       float* y, cudaStream_t stream) {
  if (n <= 0 || kc <= 0 || kc % 512) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 7) / 8), block(256);
  LK_SWITCH_NB(B, w4x_gemv_kernel<NB><<<grid, block, 0, stream>>>(x8, sx, xsum, B, codes, gs,
                                                                   gm, n, kc, y))
  return (int)cudaGetLastError();
}
