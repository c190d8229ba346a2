// Kernel 6: the Q8F (int8 fast mode) matmul at any row count,
//
//   y[b, n] = sum_s (sx[b, s] * sw[n, s]) * P[b, n, s],
//   P[b, n, s] = sum_{k in superblock s} q[n, k] * x8[b, k]   (exact int32)
//
// with q int8 [N, K] and one f32 scale per 256-superblock on both sides
// (x8/sx from the q8.cu prologue).
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_int8.py::qmm_int8.  Bound on the
// H100: bytes up to 64 rows (8.125 bits per weight streamed; each weight
// byte feeds at most 128 int8 operations there, under the card's ~590),
// operations at a 512-row prefill.  Two designs compute it, chosen by the
// wrapper's row threshold T6 (ops/cuda/qmm_int8.py::MMA_MIN_ROWS,
// Q8F_WALK_ROWS here):
//
// * up to T6 rows, q8f_gemv_kernel: one warp per output row, 8 rows per
//   block; each lane takes 16 codes per 512-byte warp load, four __dp4a
//   give its exact partial, and the 16 lanes of a superblock add theirs
//   with four shuffles before the scales apply, so P is exact.  With more
//   rows every lane re-reads each activation row from L1/L2.
// * above T6, int8 tensor cores (w8_mma.cuh's q8f_mma_kernel): a block
//   takes 128 weight rows (8 warps of 16) and one tile of up to 64
//   activation rows, a 3-stage cp.async ring of superblocks (codes, x
//   codes, both scales), ldmatrix fragments, eight chained mma.sync
//   m16n8k32 a superblock into an accumulator at 0x4B400000 (one FADD
//   gives the exact P), and K split in whole superblocks as
//   ops/cuda/qmm.py::plan says where the tiles alone leave SMs idle,
//   summed in split order by the last block.  The TPU kernel chunks
//   prefill at 1024 rows for VMEM; row tiles here cover any M.
#include "w8_mma.cuh"

// T6: the walk takes at most this many rows (the wrapper's MMA_MIN_ROWS).
constexpr int Q8F_WALK_ROWS = 2;

template <int NB>
__global__ void __launch_bounds__(256)
q8f_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx, int B,
                const int8_t* __restrict__ codes, const float* __restrict__ sw, int n, int K,
                float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;  // row is warp-uniform
  const int S = K / 256;
  const int8_t* crow = codes + (size_t)row * K;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  // K % 512 may be 256: the warp's last step then has one live half, and
  // the other half takes part in the shuffles with zeros
#pragma unroll 2
  for (int base = 0; base < K; base += 512) {
    const int c0 = base + lane * 16;
    const bool live = c0 < K;
    const int s = c0 >> 8;
    const int4 w = live ? __ldg(reinterpret_cast<const int4*>(crow + c0)) : make_int4(0, 0, 0, 0);
    const float ws = live ? __ldg(sw + (size_t)row * S + s) : 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const int4 xv = live ? *reinterpret_cast<const int4*>(x8 + (size_t)b * K + c0)
                             : make_int4(0, 0, 0, 0);
        int p = __dp4a(w.x, xv.x, 0);
        p = __dp4a(w.y, xv.y, p);
        p = __dp4a(w.z, xv.z, p);
        p = __dp4a(w.w, xv.w, p);
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) p += __shfl_xor_sync(LK_FULL_MASK, p, off);
        if (live && (lane & 15) == 0) acc[b] += (float)p * (sx[b * S + s] * ws);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0 && b < B) y[(size_t)b * n + row] = v;
  }
}

// x8 [M, K] int8, sx [M, K/256] f32; codes [N, K] int8, sw [N, K/256] f32;
// y [M, N] f32.  K % 256 == 0.  splits == 0 runs the walk (M <= T6 only);
// splits >= 1 the tensor-core tile with row tiles of bm = 16, 32 or 64 rows
// and K split in that many superblock ranges, with ws [splits, M, N] f32
// and cnt (one zeroed int an output tile of bm rows and 128 columns) when
// splits > 1.
LK_API int lk_q8f_matmul(const int8_t* x8, const float* sx, int M, const int8_t* codes,
                         const float* sw, int N, int K, float* y, int bm, int splits, float* ws,
                         int* cnt, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 256 || splits < 0 || splits > K / 256 ||
      (splits == 0 && M > Q8F_WALK_ROWS) || (splits > 0 && bm != 16 && bm != 32 && bm != 64) ||
      (splits > 1 && (!ws || !cnt || N % 4)))
    return (int)cudaErrorInvalidValue;
  if (splits >= 1)
    return w8mma::q8f_launch(x8, sx, M, codes, sw, N, K, y, bm, splits, ws, cnt, stream);
  static_assert(Q8F_WALK_ROWS == 2, "the walk's instances are those up to T6");
  if (M == 1)
    q8f_gemv_kernel<1><<<(N + 7) / 8, 256, 0, stream>>>(x8, sx, M, codes, sw, N, K, y);
  else
    q8f_gemv_kernel<2><<<(N + 7) / 8, 256, 0, stream>>>(x8, sx, M, codes, sw, N, K, y);
  return (int)cudaGetLastError();
}
