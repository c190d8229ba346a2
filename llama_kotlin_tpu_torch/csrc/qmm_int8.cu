// Kernel 6: the Q8F (int8 fast mode) matmul at any row count,
//
//   y[b, n] = sum_s (sx[b, s] * sw[n, s]) * P[b, n, s],
//   P[b, n, s] = sum_{k in superblock s} q[n, k] * x8[b, k]   (exact int32)
//
// with q int8 [N, K] and one f32 scale per 256-superblock on both sides
// (x8/sx from the q8.cu prologue).
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_int8.py::qmm_int8.  Two
// kernels, one function:
//
// * q8f_gemv_kernel, decode rows (B <= 32).  Bound: bytes (8.125 bits per
//   weight streamed; each weight byte feeds at most 64 int8 operations).
//   One warp per output row, 8 rows per block; each lane takes 16 codes
//   per 512-byte warp load, four __dp4a give its exact partial, and the
//   16 lanes of a superblock add theirs with four shuffles before the
//   scales apply, so P is exact.
// * q8f_gemm_kernel, prefill rows.  Bound at 64 rows: bytes (128 int8
//   operations per weight byte, under the card's ~590).  A 64x64 output
//   tile per block of 4 warps, K in steps of one superblock: the x and W
//   superblock tiles go to shared memory, each warp runs int8 tensor-core
//   products (mma.sync m16n8k32, s8 x s8 -> s32) over its 32x32 sub-tile,
//   and at the end of each superblock scales its int32 accumulators into
//   f32 ones.  The accumulator layout of mma.sync is fixed by the PTX ISA,
//   so each thread knows the (row, col) of every value it scales.  The TPU
//   kernel chunks prefill at 1024 rows for VMEM; blocks here cover any M.
#include "w4_dot.cuh"

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

namespace {
constexpr int TM = 64, TN = 64, SB = 256;
constexpr int LDT = SB + 16;  // byte row stride of the shared tiles (conflict-free fragments)
}  // namespace

__device__ __forceinline__ void mma_s8(int c[4], const int a[4], const int b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(128)
q8f_gemm_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                const int8_t* __restrict__ codes, const float* __restrict__ sw,
                float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[TM][LDT];
  __shared__ __align__(16) int8_t ws[TN][LDT];
  __shared__ float sxs[TM], sws[TN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group / thread in group
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int S = K / SB;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < S; ++s) {
    // superblock tiles: 64 rows x 256 bytes each, 16-byte loads, zero past M / N
    for (int idx = tid; idx < TM * SB / 16; idx += 128) {
      const int r = idx >> 4, c = (idx & 15) * 16;
      int4 xv = make_int4(0, 0, 0, 0), wv = make_int4(0, 0, 0, 0);
      if (m0 + r < M) xv = *reinterpret_cast<const int4*>(x8 + (size_t)(m0 + r) * K + s * SB + c);
      if (n0 + r < N) wv = __ldg(reinterpret_cast<const int4*>(codes + (size_t)(n0 + r) * K + s * SB + c));
      *reinterpret_cast<int4*>(&xs[r][c]) = xv;
      *reinterpret_cast<int4*>(&ws[r][c]) = wv;
    }
    if (tid < TM) sxs[tid] = m0 + tid < M ? sx[(size_t)(m0 + tid) * S + s] : 0.f;
    else sws[tid - TM] = n0 + tid - TM < N ? __ldg(sw + (size_t)(n0 + tid - TM) * S + s) : 0.f;
    __syncthreads();
    int c[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < SB; kk += 32) {
      int a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        a[i][0] = *reinterpret_cast<const int*>(&xs[r][kk + 4 * t]);
        a[i][1] = *reinterpret_cast<const int*>(&xs[r + 8][kk + 4 * t]);
        a[i][2] = *reinterpret_cast<const int*>(&xs[r][kk + 16 + 4 * t]);
        a[i][3] = *reinterpret_cast<const int*>(&xs[r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wn + 8 * j + g;
        b[j][0] = *reinterpret_cast<const int*>(&ws[r][kk + 4 * t]);
        b[j][1] = *reinterpret_cast<const int*>(&ws[r][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(c[i][j], a[i], b[j]);
    }
    // accumulator e of tile (i, j): row wm+16i+g (+8 for e >= 2),
    // col wn+8j+2t+(e&1)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm + 16 * i + g + (e >= 2 ? 8 : 0);
          const int col = wn + 8 * j + 2 * t + (e & 1);
          acc[i][j][e] += (float)c[i][j][e] * (sxs[r] * sws[col]);
        }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + 16 * i + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (r < M && col < N) y[(size_t)r * N + col] = acc[i][j][e];
      }
}

// x8 [M, K] int8, sx [M, K/256] f32; codes [N, K] int8, sw [N, K/256] f32;
// y [M, N] f32.  K % 256 == 0.  M <= 32 runs the GEMV, more rows the GEMM.
LK_API int lk_q8f_matmul(const int8_t* x8, const float* sx, int M, const int8_t* codes,
                         const float* sw, int N, int K, float* y, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 256) return (int)cudaErrorInvalidValue;
  if (M <= 32) {
    LK_SWITCH_NB(M, q8f_gemv_kernel<NB><<<dim3((N + 7) / 8), 256, 0, stream>>>(
                        x8, sx, M, codes, sw, N, K, y))
  } else {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    q8f_gemm_kernel<<<grid, 128, 0, stream>>>(x8, sx, codes, sw, y, M, N, K);
  }
  return (int)cudaGetLastError();
}
