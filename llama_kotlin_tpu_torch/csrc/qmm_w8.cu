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
// 2*32 int8 operations, far below the ~590 int8 ops per byte of memory
// bandwidth, so the floor is the weight stream: 8 bits of codes plus
// 32/GS bits of s_eff per weight (10 bits at GS=16).  Design: as kernel 1,
// one warp per output row, 8 rows per block, no shared memory; each lane
// takes 16 codes per 512-byte warp load, which is one 16-group or half of
// a 32-group.  Four __dp4a give the lane's exact partial; a 32-group adds
// its lane pair's partials with one shuffle before scaling, so every
// group's integer partial is exact, as on the TPU's int32 MXU dot.
//
// The precise branch (W8X folds of the W4X mode, NP = 2) takes the
// dual-plane prologue's 2B rows (plane p of batch row b is row p*B + b):
// each 16-byte code load is dotted with both planes and both partials add
// into the same acc[b], so the codes stream once and the halves the JAX
// entry sums after its kernel are summed here (y[B, n]).
#include "w4_dot.cuh"

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

template <int GS, int NP>
static int launch_w8(const int8_t* x8, const float* sx, int B, const int8_t* codes,
                     const float* gs, int n, int K, float* y, cudaStream_t stream) {
  const dim3 grid((n + 7) / 8), block(256);
  LK_SWITCH_NB(B, w8_gemv_kernel<NB, GS, NP><<<grid, block, 0, stream>>>(x8, sx, B, codes, gs,
                                                                         n, K, y))
  return (int)cudaGetLastError();
}

// x8 [planes*B, K] int8, sx [planes*B, K/256] f32; codes [n, K] int8; gs
// [n, K/group] f32; y [B, n] f32.  K % 512 == 0, group 16 or 32, planes 1
// (W8) or 2 (W8X: plane 2 in rows B..2B-1).
LK_API int lk_w8_gemv(const int8_t* x8, const float* sx, int B, const int8_t* codes,
                      const float* gs, int n, int K, int group, int planes, float* y,
                      cudaStream_t stream) {
  if (n <= 0 || K <= 0 || K % 512 || (group != 16 && group != 32) ||
      (planes != 1 && planes != 2))
    return (int)cudaErrorInvalidValue;
  if (group == 16)
    return planes == 1 ? launch_w8<16, 1>(x8, sx, B, codes, gs, n, K, y, stream)
                       : launch_w8<16, 2>(x8, sx, B, codes, gs, n, K, y, stream);
  return planes == 1 ? launch_w8<32, 1>(x8, sx, B, codes, gs, n, K, y, stream)
                     : launch_w8<32, 2>(x8, sx, B, codes, gs, n, K, y, stream);
}
