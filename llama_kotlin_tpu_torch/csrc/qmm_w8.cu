// Kernel 5: W8A8 matmul for decode rows (B <= 32) over the W8 fold,
// y[B, n] = x @ W^T (main term; the mins' term, for formats that have
// mins, is one matmul in the wrapper).
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w8.py::qmm_w8 (entry
// qmm_w8_matmul).  Inputs are the prologue's x8/sx (q8.cu: int8 per
// 256-superblock, amax/127) and one W8 fold: int8 element-order codes
// [n, K] and the exact f32 s_eff [n, K/GS] per 16- or 32-group.
//
//   y[b, row] = sum_g (P_g * s_eff[row, g]) * sx[b, g*GS/256],
//   P_g = sum_{c in g} codes[row, c] * x8[b, c]   (exact int32)
//
// Bound on the H100: bytes.  At B <= 32 each weight byte feeds at most
// 2*2*32 int8 operations, far below the ~590 int8 ops per byte of memory
// bandwidth, so the floor is the weight stream: 8 bits of codes plus
// 32/GS bits of s_eff per weight (10 bits at GS=16).  Two designs compute
// it, chosen by the wrapper's row threshold T5
// (ops/cuda/qmm_w8.py::MMA_MIN_ROWS, W8_WALK_ROWS here):
//
// - up to T5 rows, the walk below, as kernel 1: one warp per output row, 8
//   rows per block, no shared memory; each lane takes 16 codes per
//   512-byte warp load, which is one 16-group or half of a 32-group.  Four
//   __dp4a give the lane's exact partial; a 32-group adds its lane pair's
//   partials with one shuffle before scaling, so every group's integer
//   partial is exact, as on the TPU's int32 MXU dot.  At one row it runs
//   the lm_head at ~91% of its bound; with more rows every 16-byte code
//   load re-reads 16 bytes of every row's activations from L1/L2.
// - above T5, int8 tensor cores (w8_mma.cuh): the rows' activations are
//   staged once a superblock in shared memory for a block's 8 warps, one
//   mma.sync a group, K split in whole superblocks as ops/cuda/qmm.py::plan
//   says and summed in split order by the last block.
//
// The precise branch (W8X folds of the W4X mode, NP = 2) takes the
// dual-plane prologue's 2B rows (plane p of batch row b is row p*B + b):
// the walk dots each 16-byte code load with both planes and adds both
// partials into the same acc[b]; the tensor-core path stacks both planes
// as A rows and sums them in its epilogue, plane 0 then plane 1.  Either
// way the codes stream once and the halves the JAX entry sums after its
// kernel are summed here (y[B, n]).
#include "w8_mma.cuh"

// T5: the walk takes at most this many rows (the wrapper's MMA_MIN_ROWS).
constexpr int W8_WALK_ROWS = 2;

template <int NB, int GS, int NP>
__global__ void __launch_bounds__(256)
w8_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx, int B,
               const int8_t* __restrict__ codes, const float* __restrict__ gs, int n, int K,
               float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together: row is warp-uniform
  const int G = K / GS, S = K / 256;
  const int8_t* crow = codes + (size_t)row * K;
  const float* srow = gs + (size_t)row * G;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
#pragma unroll 2
  for (int c0 = lane * 16; c0 < K; c0 += 512) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(crow + c0));
    const float s = __ldg(srow + c0 / GS);
    const int sb = c0 >> 8;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          const int rb = pl * B + b;  // row of plane pl
          const int4 xv = *reinterpret_cast<const int4*>(x8 + (size_t)rb * K + c0);
          int p = __dp4a(w.x, xv.x, 0);
          p = __dp4a(w.y, xv.y, p);
          p = __dp4a(w.z, xv.z, p);
          p = __dp4a(w.w, xv.w, p);
          if (GS == 32) p += __shfl_xor_sync(LK_FULL_MASK, p, 1);
          if (GS == 16 || (lane & 1) == 0) acc[b] += ((float)p * s) * sx[rb * S + sb];
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0 && b < B) y[(size_t)b * n + row] = v;
  }
}

// The walk's instances: one for each batch-row bucket up to T5.
template <int GS, int NP>
static int walk(const int8_t* x8, const float* sx, int B, const int8_t* codes, const float* gs,
                int n, int K, float* y, cudaStream_t stream) {
  static_assert(W8_WALK_ROWS == 2, "the walk's instances are those up to T5");
  if (B == 1)
    w8_gemv_kernel<1, GS, NP><<<(n + 7) / 8, 256, 0, stream>>>(x8, sx, B, codes, gs, n, K, y);
  else
    w8_gemv_kernel<2, GS, NP><<<(n + 7) / 8, 256, 0, stream>>>(x8, sx, B, codes, gs, n, K, y);
  return (int)cudaGetLastError();
}

template <int GS, int NP>
static int run(const int8_t* x8, const float* sx, int B, const int8_t* codes, const float* gs,
               int n, int K, float* y, int splits, float* ws, int* cnt, cudaStream_t stream) {
  if (splits >= 1)
    return w8mma::launch<GS, NP>(x8, sx, B, codes, gs, n, K, y, splits, ws, cnt, stream);
  return walk<GS, NP>(x8, sx, B, codes, gs, n, K, y, stream);
}

// x8 [planes*B, K] int8, sx [planes*B, K/256] f32; codes [n, K] int8; gs
// [n, K/group] f32; y [B, n] f32.  K % 512 == 0, group 16 or 32, planes 1
// (W8) or 2 (W8X: plane 2 in rows B..2B-1), 1 <= B <= 32.  splits == 0
// runs the walk (B <= T5 only); splits >= 1 the tensor-core GEMM with K
// split in that many superblock ranges, with ws [splits, B, n] f32 and cnt
// (one zeroed int a 128-column tile) when splits > 1.
LK_API int lk_w8_gemv(const int8_t* x8, const float* sx, int B, const int8_t* codes,
                      const float* gs, int n, int K, int group, int planes, float* y, int splits,
                      float* ws, int* cnt, cudaStream_t stream) {
  if (n <= 0 || K <= 0 || K % 512 || (group != 16 && group != 32) ||
      (planes != 1 && planes != 2) || B < 1 || B > 32 || splits < 0 || splits > K / 256 ||
      (splits == 0 && B > W8_WALK_ROWS) || (splits > 1 && (!ws || !cnt || n % 4)))
    return (int)cudaErrorInvalidValue;
  if (group == 16)
    return planes == 1 ? run<16, 1>(x8, sx, B, codes, gs, n, K, y, splits, ws, cnt, stream)
                       : run<16, 2>(x8, sx, B, codes, gs, n, K, y, splits, ws, cnt, stream);
  return planes == 1 ? run<32, 1>(x8, sx, B, codes, gs, n, K, y, splits, ws, cnt, stream)
                     : run<32, 2>(x8, sx, B, codes, gs, n, K, y, splits, ws, cnt, stream);
}
