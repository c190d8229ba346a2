// Kernel 1: W4A8 matmul for decode rows (B <= 32), y[B, n] = x @ W^T.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4_fx2 (entry
// qmm_w4_matmul).  Inputs are the prologue's x8/sx/xsum (q8.cu) and one W4
// fold; the per-row math is w4_row_partial (w4_dot.cuh).
//
// Bound on the H100: bytes.  At B <= 32 every weight byte feeds at most
// 2*32 int8 operations, far below the card's ~590 int8 ops per byte of
// memory bandwidth, so the time floor is the weight stream (4.625 bits per
// weight for compact folds).  Design: one warp per output row so each row's
// codes stream as contiguous 512-byte warp loads, 8 rows per block, and
// no shared memory or block synchronisation; the batch rows reuse each
// 16-byte code load from registers.
#include "w4_dot.cuh"

template <int NB, bool COMPACT>
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
  w4_row_partial<NB, COMPACT>(acc, x8, sx, xsum, B, codes, q6, dd, gs, gm, row, kc, lane);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0 && b < B) y[(size_t)b * n + row] = v;
  }
}

LK_API int lk_w4_gemv(const int8_t* x8, const float* sx, const int* xsum, int B,
                      const uint8_t* codes, const uint8_t* q6, const float* dd,
                      const float* gs, const float* gm, int n, int kc, int compact, float* y,
                      cudaStream_t stream) {
  if (n <= 0 || kc <= 0 || kc % 512) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 7) / 8), block(256);
  if (compact) {
    LK_SWITCH_NB(B, w4_gemv_kernel<NB, true><<<grid, block, 0, stream>>>(
                        x8, sx, xsum, B, codes, q6, dd, gs, gm, n, kc, y))
  } else {
    LK_SWITCH_NB(B, w4_gemv_kernel<NB, false><<<grid, block, 0, stream>>>(
                        x8, sx, xsum, B, codes, q6, dd, gs, gm, n, kc, y))
  }
  return (int)cudaGetLastError();
}
