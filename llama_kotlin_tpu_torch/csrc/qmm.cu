// Kernel 4: fused dequantize-matmul for prefill rows over a W4 fold,
// y[M, N] = x[M, K] @ W^T in f32 with bf16 operands.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm.py::qmm on the W4 fold (entry
// qmm_pallas_or_none): w = plane * g_scale - g_min per element, with
// plane = raw low nibble or the pre-signed high nibble (q - 8), formed in
// f32 without contraction and rounded to bf16, as the Pallas kernel feeds
// its MXU dot; x is bf16; the products accumulate in f32.
//
// Bound on the H100: at 64 prefill rows the bf16 tensor cores need about
// 2*64 = 128 flops per weight against ~0.75 bytes per weight streamed
// (codes plus the f32 scale/min per 32-group), ~170 flops a byte — under
// the card's ~295, so still bytes.  Design: 64x64 output tiles over
// 4 warps, K in steps of 64 (two 32-groups); each step dequantizes its
// W tile into shared memory (dequantized weights never touch device
// memory) and runs bf16 WMMA 16x16x16 products with f32 accumulators.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {
constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 8;  // bf16 row stride of the shared tiles
constexpr int LDC = BN + 4;  // f32 row stride of the output staging tile
}  // namespace

__global__ void __launch_bounds__(128)
w4_dequant_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                       const float* __restrict__ gs, const float* __restrict__ gm,
                       float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(32) __nv_bfloat16 ws[BN][LDS];
  __shared__ __align__(32) float cs[BM][LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kc = K / 2, G = K / 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [64 rows][64 k]: 16-byte loads, zero past M
    for (int idx = tid; idx < BM * BK / 8; idx += 128) {
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&xs[r][c]) = val;
    }
    // W tile [64 rows n][64 k] = two 32-groups; thread -> (row, group)
    {
      const int r = tid >> 1, gi = tid & 1, n = n0 + r;
      const int e0 = k0 + gi * 32;  // first element of the group
      const int s = e0 >> 8, o = e0 & 255;
      const bool hi = o >= 128;
      __nv_bfloat16* dst = &ws[r][gi * 32];
      if (n < N) {
        const uint8_t* src = codes + (size_t)n * kc + s * 128 + (o & 127);
        const uint4 c0 = __ldg(reinterpret_cast<const uint4*>(src));
        const uint4 c1 = __ldg(reinterpret_cast<const uint4*>(src + 16));
        const float sc = __ldg(gs + (size_t)n * G + (e0 >> 5));
        const float mn = __ldg(gm + (size_t)n * G + (e0 >> 5));
        const unsigned words[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int wi = 0; wi < 8; ++wi) {
#pragma unroll
          for (int bi = 0; bi < 4; ++bi) {
            const unsigned byte = (words[wi] >> (8 * bi)) & 0xFFu;
            const float plane = hi ? (float)((int)(int8_t)(byte & 0xF0u) >> 4)
                                   : (float)(byte & 0x0Fu);
            dst[wi * 4 + bi] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(plane, sc), mn));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) dst[i] = __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &xs[wm + 16 * i][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &ws[wn + 16 * j][kk], LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wm + 16 * i][wn + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += 128) {
    const int r = idx / BN, c = idx % BN;
    if (m0 + r < M && n0 + c < N) y[(size_t)(m0 + r) * N + n0 + c] = cs[r][c];
  }
}

// x [M, K] bf16 (K = the fold's k_pad, zero-padded); codes [N, K/2] u8;
// g_scale/g_min [N, K/32] f32; y [M, N] f32.
LK_API int lk_w4_dequant_gemm(const __nv_bfloat16* x, const uint8_t* codes, const float* gs,
                              const float* gm, float* y, int M, int N, int K,
                              cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 256) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4_dequant_gemm_kernel<<<grid, 128, 0, stream>>>(x, codes, gs, gm, y, M, N, K);
  return (int)cudaGetLastError();
}
