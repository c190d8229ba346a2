// Kernel 4: fused dequantize-matmul for prefill rows over a W4 or a W8
// fold, y[M, N] = x[M, K] @ W^T in f32 with bf16 operands.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm.py::qmm (entry
// qmm_pallas_or_none) on the W4 fold and, in its bits == 8 branch, on the
// W8 fold.  The weight operand is what the Pallas kernel feeds its MXU
// dot, formed in f32 without contraction and rounded to bf16:
//   W4: w = plane * g_scale - g_min, plane = the raw low nibble or the
//       pre-signed high nibble (q - 8);
//   W8: w = code * s_eff (- m_eff), groups of 16 or 32.
// x is bf16; the products accumulate in f32.  Only the f32 summation
// order differs from the plain version (ops/cuda/qmm.py::qmm_plain).
//
// Bound on the H100: bytes at 64 rows (~170 flops a streamed byte for W4,
// under the card's ~295 bf16 flops a byte), operations from a few hundred
// rows.  The design, for 132 SMs:
// * Tiles of BM = 32, 64 or 128 rows by BN = 128 weight rows, 4 warps;
//   each warp owns 32 weight rows, so every weight is dequantized once a
//   block, and each x fragment it loads from shared memory feeds 4
//   products.
// * K is split so that every projection fills the card at 64 rows (the
//   wrapper's plan(): at span boundaries for W4, 64-element group
//   boundaries for W8).  Each split stores its f32 partial tile in a
//   workspace; the last split to arrive sums the partials in split order
//   (an int counter, no float atomics), so outputs repeat bit for bit.
// * A 3-stage cp.async ring (2 at BM = 128) holds the x tile, the raw
//   codes and the group scales/mins of each K step, so the next steps
//   load while the tensor cores work on this one.
// * mma.sync m16n8k16 bf16 (chosen over wgmma: the B operand is formed in
//   registers from the codes, where wgmma would need the dequantized tile
//   written back to shared memory in its swizzled layout).  Each thread
//   dequantizes whole 32-bit code words straight into its B fragments:
//   the k order inside each 16-wide product is permuted so that thread t
//   of a quad takes 16 consecutive code bytes, and x, read with the same
//   permutation, comes in 16-byte shared loads.  A W4 step is 64 code
//   bytes a row: 64 low-nibble elements and the 64 high-nibble elements
//   128 further on (the fold's plane packing); a W8 step 64 codes.
// On the card the dequantization (about 4 instructions a weight, kept
// bit-exact in f32), the products and the x tile's loads each cost about
// as much, and they overlap only in part: the kernel stays well above its
// bytes bound at 64 rows (PERF.md, kernel 4 rows).
#include "mma_pipe.cuh"

namespace {
constexpr int BN = 128, WN = 4;  // 4 warps of 32 weight rows
}  // namespace

template <bool W4, int GS, bool HAS_MIN, int MT>
struct DqTile {
  static constexpr int NH = W4 ? 2 : 1;        // x halves a step (W4: lo and hi elements)
  static constexpr int NG = W4 ? 4 : 64 / GS;  // scale groups a weight row a step
  static constexpr int SPU = W4 ? 2 : 1;       // steps a split unit (256 / 64 elements)
  static constexpr int BM = 16 * MT, THREADS = 32 * WN;
  static constexpr int X_LD = NH * 128 + 16;   // bytes a row of the x tile (conflict-free)
  static constexpr int X_BYTES = BM * X_LD, C_BYTES = BN * 64, S_BYTES = BN * NG * 4;
  static constexpr int STAGE = X_BYTES + C_BYTES + S_BYTES * (HAS_MIN ? 2 : 1);
  static constexpr int STAGES = MT == 8 ? 2 : 3;
  static constexpr int SMEM = STAGE * STAGES;
};

// Issue the copies of step q (global step index) into stage `st`.
template <bool W4, int GS, bool HAS_MIN, int MT>
__device__ __forceinline__ void dq_load(uint8_t* st, int q, const __nv_bfloat16* __restrict__ x,
                                        const uint8_t* __restrict__ codes,
                                        const float* __restrict__ gs,
                                        const float* __restrict__ gm, int M, int N, int K,
                                        int m0, int n0) {
  using T = DqTile<W4, GS, HAS_MIN, MT>;
  const int tid = threadIdx.x;
  // first element of the step's low half: W4 256 s + 64 j, W8 64 q
  const int e0 = W4 ? (q >> 1) * 256 + (q & 1) * 64 : q * 64;
  for (int idx = tid; idx < T::BM * T::NH * 8; idx += T::THREADS) {
    const int r = idx / (T::NH * 8), h = (idx >> 3) % T::NH, c = idx & 7;
    const bool ok = m0 + r < M;
    const __nv_bfloat16* src = x + (size_t)(ok ? m0 + r : 0) * K + e0 + h * 128 + c * 8;
    cp_async16(st + r * T::X_LD + h * 128 + c * 16, src, ok ? 16 : 0);
  }
  const int kb = W4 ? K / 2 : K;                              // code bytes a row
  const int c0 = W4 ? (q >> 1) * 128 + (q & 1) * 64 : q * 64;  // the step's first code byte
  uint8_t* cs = st + T::X_BYTES;
  for (int idx = tid; idx < BN * 4; idx += T::THREADS) {
    const int r = idx >> 2, c = idx & 3;
    const bool ok = n0 + r < N;
    cp_async16(cs + r * 64 + c * 16, codes + (size_t)(ok ? n0 + r : 0) * kb + c0 + c * 16,
               ok ? 16 : 0);
  }
  const int G = K / (W4 ? 32 : GS);
  float* ss = reinterpret_cast<float*>(cs + T::C_BYTES);
  float* ms = ss + BN * T::NG;
  if constexpr (W4) {
    // per row: lo groups e0/32 + {0, 1}, hi groups 4 further on
    for (int idx = tid; idx < BN * 2; idx += T::THREADS) {
      const int r = idx >> 1, h = idx & 1;
      const bool ok = n0 + r < N;
      const size_t g = (size_t)(ok ? n0 + r : 0) * G + (e0 >> 5) + 4 * h;
      cp_async8(ss + r * 4 + 2 * h, gs + g, ok ? 8 : 0);
      cp_async8(ms + r * 4 + 2 * h, gm + g, ok ? 8 : 0);
    }
  } else {
    for (int r = tid; r < BN; r += T::THREADS) {
      const bool ok = n0 + r < N;
      const size_t g = (size_t)(ok ? n0 + r : 0) * G + e0 / GS;
      if constexpr (T::NG == 4) {
        cp_async16(ss + r * 4, gs + g, ok ? 16 : 0);
        if (HAS_MIN) cp_async16(ms + r * 4, gm + g, ok ? 16 : 0);
      } else {
        cp_async8(ss + r * 2, gs + g, ok ? 8 : 0);
        if (HAS_MIN) cp_async8(ms + r * 2, gm + g, ok ? 8 : 0);
      }
    }
  }
}

// The tensor-core work of one step held in stage `st`.
template <bool W4, int GS, bool HAS_MIN, int MT>
__device__ __forceinline__ void dq_step(const uint8_t* st, float acc[MT][4][4], int warp, int g,
                                        int t) {
  using T = DqTile<W4, GS, HAS_MIN, MT>;
  const uint8_t* cs = st + T::X_BYTES;
  const float* ss = reinterpret_cast<const float*>(cs + T::C_BYTES);
  const float* ms = ss + BN * T::NG;
  // the code words of weight rows warp*32 + 8 nt + g, bytes 16t..16t+15:
  // word c gives the k16 product c of each half
  uint32_t words[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const uint4 wv = *reinterpret_cast<const uint4*>(cs + (warp * 32 + nt * 8 + g) * 64 + t * 16);
    words[nt][0] = wv.x;
    words[nt][1] = wv.y;
    words[nt][2] = wv.z;
    words[nt][3] = wv.w;
  }
#pragma unroll
  for (int h = 0; h < T::NH; ++h) {
    uint32_t b[4][4][2];  // B fragments of this half
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = warp * 32 + nt * 8 + g;
      if constexpr (W4) {
        // thread t's 16 elements of each half lie in group t / 2 of it
        const int gi = 2 * h + (t >> 1);
        const float s = ss[row * 4 + gi], m = ms[row * 4 + gi];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (h == 0) dequant_w4_lo(words[nt][c], s, m, b[nt][c]);
          else dequant_w4_hi(words[nt][c], s, m, b[nt][c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int gi = (16 * t + 4 * c) / GS;
          const float s = ss[row * T::NG + gi];
          const float m = HAS_MIN ? ms[row * T::NG + gi] : 0.f;
          dequant_w8_word<HAS_MIN>(words[nt][c], s, m, b[nt][c]);
        }
      }
    }
    // A fragments: x rows mt*16 + g (+8), elements 16t..16t+15 of half h
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* r0 = st + (mt * 16 + g) * T::X_LD + h * 128 + t * 32;
      const uint8_t* r1 = r0 + 8 * T::X_LD;
      const uint4 p0 = *reinterpret_cast<const uint4*>(r0);
      const uint4 p1 = *reinterpret_cast<const uint4*>(r0 + 16);
      const uint4 q0 = *reinterpret_cast<const uint4*>(r1);
      const uint4 q1 = *reinterpret_cast<const uint4*>(r1 + 16);
      const uint32_t x0[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const uint32_t x1[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t a[4] = {x0[2 * c], x1[2 * c], x0[2 * c + 1], x1[2 * c + 1]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][c]);
      }
    }
  }
}

template <bool W4, int GS, bool HAS_MIN, int MT>
__global__ void __launch_bounds__(DqTile<W4, GS, HAS_MIN, MT>::THREADS, MT == 2 ? 3 : MT == 4 ? 2 : 1)
dequant_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                    const float* __restrict__ gs, const float* __restrict__ gm,
                    float* __restrict__ y, int M, int N, int K, int splits,
                    float* __restrict__ ws, int* __restrict__ cnt) {
  using T = DqTile<W4, GS, HAS_MIN, MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM, z = blockIdx.z;
  int u0, u1;
  split_range(z, splits, K / (64 * T::NH * T::SPU), &u0, &u1);
  const int q0 = u0 * T::SPU, nq = (u1 - u0) * T::SPU;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nq)
      dq_load<W4, GS, HAS_MIN, MT>(smem + s * T::STAGE, q0 + s, x, codes, gs, gm, M, N, K, m0,
                                   n0);
    cp_async_commit();
  }
  for (int i = 0; i < nq; ++i) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1's stage
    const int nxt = i + T::STAGES - 1;
    if (nxt < nq)
      dq_load<W4, GS, HAS_MIN, MT>(smem + (nxt % T::STAGES) * T::STAGE, q0 + nxt, x, codes, gs,
                                   gm, M, N, K, m0, n0);
    cp_async_commit();
    dq_step<W4, GS, HAS_MIN, MT>(smem + (i % T::STAGES) * T::STAGE, acc, warp, g, t);
  }
  cp_async_wait<0>();

  // accumulator e of (mt, nt): row mt*16 + g (+8 for e >= 2), column
  // warp*32 + 8 nt + 2t + (e & 1)
  float* out = splits == 1 ? y : ws + (size_t)z * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + warp * 32 + nt * 8 + 2 * t + (e & 1);
        if (r < M && col < N) out[(size_t)r * N + col] = acc[mt][nt][e];
      }
  if (splits > 1 && split_arrive_last(cnt, blockIdx.y * gridDim.x + blockIdx.x, splits))
    split_sum(ws, y, splits, (size_t)M * N, N, m0, min(T::BM, M - m0), n0, min(BN, N - n0));
}

template <bool W4, int GS, bool HAS_MIN, int MT>
static int launch(const __nv_bfloat16* x, const uint8_t* codes, const float* gs,
                  const float* gm, float* y, int M, int N, int K, int splits, float* ws,
                  int* cnt, cudaStream_t stream) {
  using T = DqTile<W4, GS, HAS_MIN, MT>;
  auto kern = dequant_gemm_kernel<W4, GS, HAS_MIN, MT>;
  static bool sized = false;  // the attribute is set once a process
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM, splits);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(x, codes, gs, gm, y, M, N, K, splits, ws, cnt);
  return (int)cudaGetLastError();
}

// The plan's checks, shared by both entries: bm is 32, 64 or 128; splits
// cover units of `unit` elements, at least one a split; a split plan
// brings its workspace [splits, M, N] f32 and one zeroed int counter per
// output tile, and N % 4 == 0 (the fixed-order sum reads float4 rows).
static bool plan_ok(int M, int N, int K, int unit, int bm, int splits, const float* ws,
                    const int* cnt) {
  return M > 0 && N > 0 && K > 0 && K % unit == 0 && (bm == 32 || bm == 64 || bm == 128) &&
         splits >= 1 && splits <= K / unit && (splits == 1 || (ws && cnt && N % 4 == 0));
}

// x [M, K] bf16 (K = the fold's k_pad, zero-padded); codes [N, K/2] u8;
// g_scale/g_min [N, K/32] f32; y [M, N] f32.  (bm, splits) from
// ops/cuda/qmm.py::plan; ws [splits, M, N] f32 and cnt (one int a tile,
// zero) when splits > 1.
LK_API int lk_w4_dequant_gemm(const __nv_bfloat16* x, const uint8_t* codes, const float* gs,
                              const float* gm, float* y, int M, int N, int K, int bm,
                              int splits, float* ws, int* cnt, cudaStream_t stream) {
  if (!plan_ok(M, N, K, 256, bm, splits, ws, cnt)) return (int)cudaErrorInvalidValue;
  if (bm == 32) return launch<true, 32, true, 2>(x, codes, gs, gm, y, M, N, K, splits, ws, cnt, stream);
  if (bm == 64) return launch<true, 32, true, 4>(x, codes, gs, gm, y, M, N, K, splits, ws, cnt, stream);
  return launch<true, 32, true, 8>(x, codes, gs, gm, y, M, N, K, splits, ws, cnt, stream);
}

// x [M, K] bf16 (K = the fold's k_pad, zero-padded); codes [N, K] int8;
// g_scale [N, K/group] f32, g_min the same or NULL; y [M, N] f32; the
// plan as for the W4 branch, in units of 64 elements.
LK_API int lk_w8_dequant_gemm(const __nv_bfloat16* x, const int8_t* codes, const float* gs,
                              const float* gm, float* y, int M, int N, int K, int group, int bm,
                              int splits, float* ws, int* cnt, cudaStream_t stream) {
  if (!plan_ok(M, N, K, 64, bm, splits, ws, cnt) || (group != 16 && group != 32))
    return (int)cudaErrorInvalidValue;
  const uint8_t* c = reinterpret_cast<const uint8_t*>(codes);
#define LK_W8(GSV, MIN)                                                                       \
  return bm == 32   ? launch<false, GSV, MIN, 2>(x, c, gs, gm, y, M, N, K, splits, ws, cnt, stream) \
         : bm == 64 ? launch<false, GSV, MIN, 4>(x, c, gs, gm, y, M, N, K, splits, ws, cnt, stream) \
                    : launch<false, GSV, MIN, 8>(x, c, gs, gm, y, M, N, K, splits, ws, cnt, stream)
  if (group == 16 && gm) LK_W8(16, true);
  if (group == 16) LK_W8(16, false);
  if (gm) LK_W8(32, true);
  LK_W8(32, false);
#undef LK_W8
}
