// Kernel 8: W4A8 matmul for decode rows with the activation quantization
// inside the launch, y[B, n] f32 = W4A8(x) W^T for x [B <= 32, k] f32 and a
// sym or legacy W4 fold.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4.py::qmm_w4_fx (the
// LKTPU_W4_FX=1 route of qmm_w4_matmul on non-compact, non-precise folds):
// raw f32 rows in, y out, in one launch.  The function is kernel 1's
// (qmm_w4.cu): per-256 int8 codes of x (quantize8_sb, the JAX package's
// quantize_activations formula), exact integer per-32-group partials, the
// group scale and the min term in f32 (legacy: m per group, read from
// g_min; sym: m = 8 s, formed from the scale as the JAX kernel derives it
// from scw_lo), by w4_span_partial (w4_dot.cuh).
//
// Bound on the H100: bytes, the weight stream (codes plus f32 g_scale: 5
// bits a weight for sym folds; plus f32 g_min: 6 bits for legacy ones), at
// B <= 32 far below the int8 rate.  Two designs compute it, chosen by the
// wrapper's row threshold T8 (ops/cuda/qmm_w4_fx.py::MMA_MIN_ROWS,
// FX_WALK_ROWS here):
//
// - up to T8 rows, the walk below.  The cost it adds is the one the TPU
//   kernel has (it repeats its prep per n-block): every block quantizes all
//   of x, since blocks cannot share shared memory.  A block walks k in
//   tiles of KT elements; per tile it quantizes x[:, tile] into shared
//   memory (one warp per 256-element superblock), then each of its 16
//   warps runs its rows over that tile and adds the warp-summed partial
//   into a shared accumulator.  The host picks rows per warp so that a
//   block's weight bytes stay large next to the x it re-quantizes.  Past a
//   few rows it is bound by the activations' shared-memory reads and
//   __dp4a issue (two LDS.128 and eight __dp4a a row per 16 code bytes),
//   and above 8 rows one block an SM re-quantizes all of x.
// - above T8, kernel 7's int8 tensor-core tile with one plane
//   (w4_mma.cuh::w4_fx_mma_kernel): a block takes 128 weight rows and a K
//   range of whole spans (split K as ops/cuda/qmm.py::plan says, summed in
//   split order by the last block), and quantizes each span of its rows of
//   x once, into the stage the products read; one mma.sync m16n8k32 is one
//   32-group, exact int32 partials.  That quantization, repeated by every
//   128-column tile, is most of its time above the library's; its division
//   is common.cuh's branch-free div_nb, the quotient __fdiv_rn gives
//   without its branches (PERF.md, kernel 8).
#include "w4_dot.cuh"
#include "w4_mma.cuh"

// T8: the walk takes at most this many rows (the wrapper's MMA_MIN_ROWS).
constexpr int FX_WALK_ROWS = 4;

constexpr int kFxWarps = 16;

template <int NB, bool SYM>
__global__ void __launch_bounds__(kFxWarps * 32)
w4_fx_kernel(const float* __restrict__ x, int B, const uint8_t* __restrict__ codes,
             const float* __restrict__ gs, const float* __restrict__ gm, int n, int kc, int KT,
             int RW, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* x8t = reinterpret_cast<int8_t*>(smem);                   // [NB][KT]
  float* sxt = reinterpret_cast<float*>(x8t + (size_t)NB * KT);     // [NB][KT/256]
  int* xst = reinterpret_cast<int*>(sxt + NB * (KT / 256));         // [NB][KT/32]
  float* accs = reinterpret_cast<float*>(xst + NB * (KT / 32));     // [16 RW][NB]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = 2 * kc, rows = kFxWarps * RW;
  const int row0 = blockIdx.x * rows + warp * RW;  // this warp's first row
  for (int i = threadIdx.x; i < rows * NB; i += blockDim.x) accs[i] = 0.f;
  for (int t0 = 0; t0 < k; t0 += KT) {
    const int tk = min(KT, k - t0), nsb = tk / 256;
    __syncthreads();  // the previous tile's readers are done
    for (int u = warp; u < B * nsb; u += kFxWarps) {
      const int b = u / nsb, s = u - b * nsb;
      const float* xs = x + (size_t)b * k + t0 + s * 256 + lane * 8;
      const float4 a = *reinterpret_cast<const float4*>(xs);
      const float4 c = *reinterpret_cast<const float4*>(xs + 4);
      const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      __align__(8) int8_t q[8];
      int gsum;
      const float d = quantize8_sb(v, q, &gsum);
      *reinterpret_cast<int2*>(x8t + (size_t)b * KT + s * 256 + lane * 8) =
          *reinterpret_cast<const int2*>(q);
      if ((lane & 3) == 0) xst[b * (KT / 32) + s * 8 + lane / 4] = gsum;
      if (lane == 0) sxt[b * (KT / 256) + s] = d;
    }
    __syncthreads();
    for (int r = 0; r < RW; ++r) {
      const int row = row0 + r;
      if (row >= n) break;  // warp-uniform
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      w4_span_partial<NB, false, 1, SYM>(acc, x8t, sxt, xst, B, KT, codes, nullptr, nullptr, gs, gm,
                                 row, kc, t0 / 2, (t0 + tk) / 2, lane);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float v = warp_sum(acc[b]);
        if (lane == 0 && b < B) accs[(warp * RW + r) * NB + b] += v;
      }
    }
  }
  __syncwarp();
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + r;
    if (row >= n) break;
    for (int b = lane; b < B; b += 32) y[(size_t)b * n + row] = accs[(warp * RW + r) * NB + b];
  }
}

template <int NB, bool SYM>
static int launch_walk(const float* x, int B, const uint8_t* codes, const float* gs,
                       const float* gm, int n, int kc, float* y, cudaStream_t stream) {
  const int k = 2 * kc;
  // x tile: up to 96 KB of int8 codes, a whole number of 1024-column steps
  const int kt_max = ((96 * 1024 / NB) / 1024) * 1024;
  const int KT = k < kt_max ? k : kt_max;
  // blocks per SM aimed at: 4 at B <= 2, 2 at B <= 8, else 1
  const int per_sm = NB <= 2 ? 4 : NB <= 8 ? 2 : 1;
  int sms = 0;
  cudaError_t err = lk_sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int target = sms * per_sm;
  int RW = (n + kFxWarps * target - 1) / (kFxWarps * target);
  RW = RW < 1 ? 1 : RW > 64 ? 64 : RW;
  const int rows = kFxWarps * RW;
  const size_t smem = (size_t)NB * KT + (size_t)NB * (KT / 256) * 4 +
                      (size_t)NB * (KT / 32) * 4 + (size_t)rows * NB * 4;
  auto kern = w4_fx_kernel<NB, SYM>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + rows - 1) / rows, kFxWarps * 32, smem, stream>>>(x, B, codes, gs, gm, n, kc, KT,
                                                               RW, y);
  return (int)cudaGetLastError();
}

// The walk's instances: one for each batch-row bucket up to T8.
template <bool SYM>
static int walk(const float* x, int B, const uint8_t* codes, const float* gs, const float* gm,
                int n, int kc, float* y, cudaStream_t stream) {
  static_assert(FX_WALK_ROWS == 4, "the walk's instances are those up to T8");
  if (B == 1) return launch_walk<1, SYM>(x, B, codes, gs, gm, n, kc, y, stream);
  if (B == 2) return launch_walk<2, SYM>(x, B, codes, gs, gm, n, kc, y, stream);
  return launch_walk<4, SYM>(x, B, codes, gs, gm, n, kc, y, stream);
}

// x: [B, 2 kc] f32 (k padded to the fold's k_pad), 1 <= B <= 32; codes
// [n, kc] u8; gs, gm [n, 2 kc / 32] f32; sym != 0 for a sym fold (gm is
// then not read and may be null); y [B, n] f32.  splits == 0 runs the walk
// (B <= T8 only); splits >= 1 the tensor-core GEMM with K split in that
// many span ranges, with ws [splits, B, n] f32 and cnt (one zeroed int a
// 128-column tile) when splits > 1.  x8_out, sx_out, xsum_out (null, or
// all three; tensor-core path only) receive the launch's activation codes,
// scales and group sums in lk_quantize_q8's layout.
LK_API int lk_w4_fx_gemv(const float* x, int B, const uint8_t* codes, const float* gs,
                         const float* gm, int sym, int n, int kc, float* y, int splits,
                         float* ws, int* cnt, int8_t* x8_out, float* sx_out, int* xsum_out,
                         cudaStream_t stream) {
  if (n <= 0 || kc <= 0 || kc % 512 || B < 1 || B > 32 || (!sym && !gm) || splits < 0 ||
      splits > kc / 128 || (splits == 0 && (B > FX_WALK_ROWS || x8_out)) ||
      (splits > 1 && (!ws || !cnt || n % 4)) || (!x8_out != !sx_out) || (!x8_out != !xsum_out))
    return (int)cudaErrorInvalidValue;
  if (splits >= 1)
    return sym ? w4mma::launch_fx<true>(x, B, codes, gs, gm, n, kc, y, splits, ws, cnt, x8_out,
                                        sx_out, xsum_out, stream)
               : w4mma::launch_fx<false>(x, B, codes, gs, gm, n, kc, y, splits, ws, cnt, x8_out,
                                         sx_out, xsum_out, stream);
  return sym ? walk<true>(x, B, codes, gs, gm, n, kc, y, stream)
             : walk<false>(x, B, codes, gs, gm, n, kc, y, stream);
}
