// Kernel 4, exact branches: the fused dequantize-matmul over an exact
// repack (the exact-dequant mode's layout), y[M, N] = x[M, K] @ W^T in f32
// with bf16 operands, at any number of rows.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm.py::qmm (its pallas_call at
// :349) on the standard repacks of quant/repack.py: 8-bit codes (Q5_0,
// Q5_1, Q5_K, Q3_K, Q6_K, Q8_0), 4-bit planes (Q4_0, Q4_1, Q4_K; byte j of
// span s holds element 256 s + j in its low nibble and 256 s + 128 + j in
// its high nibble) and 2-bit planes (Q2_K; byte j holds elements
// 256 s + 64 p + j in bits 2p..2p+1), group 16 or 32, the group scales as
// f32, uint8 or int8, optional group mins (f32, uint8 or int8), optional
// f32 superblock scales and superblock mins.  The weight is formed in f32
// in the Pallas kernel's order (_tile_dequant_dot, qmm.py:82-109):
//   sc  = g_scale (as f32) * sb_scale            (the product only with sb)
//   adj = sc * code_offset + g_min * sb_min      (each term only if present)
//   w   = plane * sc - adj
// each step rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn: no
// contraction), then rounded to bf16.  plane is the raw code: int8 for
// 8-bit codes (uint8 codes 0..31 read the same), the raw nibble or 2-bit
// field otherwise.  x is bf16; the products accumulate in f32.  Only the
// f32 summation order differs from the plain version
// (ops/cuda/qmm.py::qmm_plain).
//
// The design is kernel 4's W4/W8 GEMM (qmm.cu) on another weight stage:
// tiles of BM = 32 or 64 rows by BN = 128 weight rows, 4 warps of 32
// weight rows, K split as the wrapper's plan() says (units of 64 elements
// for 8-bit codes, of a 256-element span for 4- and 2-bit planes, so a
// split never cuts a span's planes apart), the splits' f32 partials summed
// in split order by the last block of a tile (outputs repeat bit for bit),
// a 3-stage cp.async ring and mma.sync m16n8k16 bf16.  A step is 64 code
// bytes of every weight row: 64 elements of 8-bit codes, 2 x 64 of 4-bit
// planes (elements c0 + j and 128 + c0 + j of a span) or the 4 x 64 of a
// span's 2-bit planes; each 64-element piece is a "half" h with its own
// 64 columns of the x tile.  The stage also holds, per weight row, the raw
// group scale and min bytes of the step's span (at most 64 bytes each) and
// the span's superblock scale and min; once a step lands, the block turns
// them into one f32 (sc, adj) pair per row and group of the step
// (ex_convert), so each weight costs one product and one difference.
// Integer planes convert to f32 exactly.  Correct first: the one-row
// decode runs on a 32-row tile (PERF.md, kernel 4's exact rows).
#include "mma_pipe.cuh"

namespace {
constexpr int BN = 128, WN = 4, THREADS = 32 * WN;
constexpr int RAW = 64;  // bytes of a row's raw group plane a stage (16 f32 groups)
constexpr int NGH = 4;   // groups of a 64-element half at most (group 16)
enum : int { DT_F32 = 0, DT_U8 = 1, DT_I8 = 2 };  // scale plane dtypes

struct ExArgs {
  const __nv_bfloat16* x;
  const uint8_t* codes;
  const uint8_t* gs;  // g_scale [N, K / group], dtype sdt
  const uint8_t* gm;  // g_min, dtype mdt, or NULL
  const float* sb;    // sb_scale [N, K / 256] or NULL
  const float* sbm;   // sb_min or NULL (only with gm and sb)
  float* y;
  int M, N, K, gshift, sdt, mdt;
  float off;
  int splits;
  float* ws;
  int* cnt;
};

template <int BITS, int MT>
struct ExTile {
  static constexpr int NH = 8 / BITS;             // 64-element halves a step
  static constexpr int SPU = BITS == 4 ? 2 : 1;   // steps a split unit
  static constexpr int BM = 16 * MT;
  static constexpr int X_LD = NH * 128 + 16;      // bytes a row of the x tile (conflict-free)
  static constexpr int X_BYTES = BM * X_LD, C_BYTES = BN * 64, R_BYTES = BN * RAW;
  static constexpr int STAGE = X_BYTES + C_BYTES + 2 * R_BYTES + 2 * BN * 4;
  static constexpr int STAGES = 3;
  static constexpr int CONV = BN * NH * NGH * 8;  // float2 (sc, adj) per row, half, group
  static constexpr int SMEM = STAGE * STAGES + CONV;
};

// The first element of half h of step q, and its offset in its span.
template <int BITS>
__device__ __forceinline__ int half_elem(int q, int h) {
  if (BITS == 8) return q * 64;
  if (BITS == 4) return (q >> 1) * 256 + h * 128 + (q & 1) * 64;
  return q * 256 + h * 64;
}
template <int BITS>
__device__ __forceinline__ int span_of(int q) {
  return BITS == 8 ? q >> 2 : BITS == 4 ? q >> 1 : q;
}

__device__ __forceinline__ int dt_bytes(int dt) { return dt == DT_F32 ? 4 : 1; }

// Issue the copies of step q into stage `st`.
template <int BITS, int MT>
__device__ __forceinline__ void ex_load(uint8_t* st, int q, const ExArgs& a, int m0, int n0) {
  using T = ExTile<BITS, MT>;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < T::BM * T::NH * 8; idx += THREADS) {
    const int r = idx / (T::NH * 8), h = (idx >> 3) % T::NH, c = idx & 7;
    const bool ok = m0 + r < a.M;
    const __nv_bfloat16* src =
        a.x + (size_t)(ok ? m0 + r : 0) * a.K + half_elem<BITS>(q, h) + c * 8;
    cp_async16(st + r * T::X_LD + h * 128 + c * 16, src, ok ? 16 : 0);
  }
  const int kb = a.K / (8 / BITS);  // code bytes a row
  uint8_t* cs = st + T::X_BYTES;
  for (int idx = tid; idx < BN * 4; idx += THREADS) {
    const int r = idx >> 2, c = idx & 3;
    const bool ok = n0 + r < a.N;
    cp_async16(cs + r * 64 + c * 16, a.codes + (size_t)(ok ? n0 + r : 0) * kb + q * 64 + c * 16,
               ok ? 16 : 0);
  }
  // the raw group planes of the step's span: 256 / group entries a row
  const int s = span_of<BITS>(q), gps = 256 >> a.gshift, G = a.K >> a.gshift;
  uint8_t* ss = cs + T::C_BYTES;
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    const uint8_t* src = pl ? a.gm : a.gs;
    if (src == nullptr) continue;
    const int esz = dt_bytes(pl ? a.mdt : a.sdt), rb = gps * esz;
    const int chunk = rb >= 16 ? 16 : 8, per = rb / chunk;
    uint8_t* dst = ss + pl * T::R_BYTES;
    for (int idx = tid; idx < BN * per; idx += THREADS) {
      const int r = idx / per, c = idx % per;
      const bool ok = n0 + r < a.N;
      const uint8_t* p = src + ((size_t)(ok ? n0 + r : 0) * G + (size_t)s * gps) * esz + c * chunk;
      if (chunk == 16) cp_async16(dst + r * RAW + c * 16, p, ok ? 16 : 0);
      else cp_async8(dst + r * RAW + c * 8, p, ok ? 8 : 0);
    }
  }
  float* sbs = reinterpret_cast<float*>(ss + 2 * T::R_BYTES);
  const int S = a.K / 256;
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    const float* src = pl ? a.sbm : a.sb;
    if (src == nullptr) continue;
    for (int r = tid; r < BN; r += THREADS) {
      const bool ok = n0 + r < a.N;
      cp_async4(sbs + pl * BN + r, src + (size_t)(ok ? n0 + r : 0) * S + s, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float raw_scale(const uint8_t* row, int i, int dt) {
  if (dt == DT_F32) return reinterpret_cast<const float*>(row)[i];
  if (dt == DT_U8) return (float)row[i];
  return (float)(int8_t)row[i];
}

// The (sc, adj) pair of every weight row and group of the step held in
// stage `st`, in the Pallas kernel's order, into conv[(row * NH + h) * NGH + j]
// (group j of half h).
template <int BITS, int MT>
__device__ __forceinline__ void ex_convert(const uint8_t* st, float2* conv, int q,
                                           const ExArgs& a) {
  using T = ExTile<BITS, MT>;
  const uint8_t* ss = st + T::X_BYTES + T::C_BYTES;
  const float* sbs = reinterpret_cast<const float*>(ss + 2 * T::R_BYTES);
  const int ngh = 64 >> a.gshift;
  for (int idx = threadIdx.x; idx < BN * T::NH * ngh; idx += THREADS) {
    const int j = idx % ngh, h = (idx / ngh) % T::NH, r = idx / (ngh * T::NH);
    const int lg = ((half_elem<BITS>(q, h) & 255) >> a.gshift) + j;  // group in the span
    float sc = raw_scale(ss + r * RAW, lg, a.sdt);
    if (a.sb) sc = __fmul_rn(sc, sbs[r]);
    float adj = a.off != 0.f ? __fmul_rn(sc, a.off) : 0.f;
    if (a.gm) {
      float mn = raw_scale(ss + T::R_BYTES + r * RAW, lg, a.mdt);
      if (a.sbm) mn = __fmul_rn(mn, sbs[BN + r]);
      adj = a.off != 0.f ? __fadd_rn(adj, mn) : mn;
    }
    conv[(r * T::NH + h) * NGH + j] = make_float2(sc, adj);
  }
}

// 4 codes of plane h of a code word as w = plane * sc - adj in f32 without
// contraction, rounded to bf16 pairs: out[0] = elements 0, 1, out[1] = 2, 3.
// (adj = 0 where the layout has no offset and no min: x - 0 is x.)
template <int BITS>
__device__ __forceinline__ void dequant_exact(uint32_t w, int h, float sc, float adj,
                                              uint32_t out[2]) {
  float f[4];
  if constexpr (BITS == 8) {
    const uint32_t u = w ^ 0x80808080u;  // code + 128 in each byte
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __fsub_rn(__fmul_rn(byte_f(u, i) - 8388736.f, sc), adj);
  } else {
    const uint32_t v = (w >> (BITS * h)) & (BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __fsub_rn(__fmul_rn(byte_f(v, i) - 8388608.f, sc), adj);
  }
  out[0] = pack_bf16(f[0], f[1]);
  out[1] = pack_bf16(f[2], f[3]);
}

// The tensor-core work of one step: weights from stage `st`'s codes and
// the converted pairs, x from its tile; the k order inside each 16-wide
// product is permuted as in qmm.cu (thread t of a quad takes 16
// consecutive code bytes, and x with the same permutation).
template <int BITS, int MT>
__device__ __forceinline__ void ex_step(const uint8_t* st, const float2* conv,
                                        float acc[MT][4][4], int warp, int g, int t,
                                        int gshift) {
  using T = ExTile<BITS, MT>;
  const uint8_t* cs = st + T::X_BYTES;
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
    uint32_t b[4][4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2* cv = conv + ((warp * 32 + nt * 8 + g) * T::NH + h) * NGH;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 p = cv[(16 * t + 4 * c) >> gshift];
        dequant_exact<BITS>(words[nt][c], h, p.x, p.y, b[nt][c]);
      }
    }
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
        const uint32_t af[4] = {x0[2 * c], x1[2 * c], x0[2 * c + 1], x1[2 * c + 1]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, b[nt][c]);
      }
    }
  }
}

template <int BITS, int MT>
__global__ void __launch_bounds__(THREADS) exact_gemm_kernel(const ExArgs a) {
  using T = ExTile<BITS, MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  float2* conv = reinterpret_cast<float2*>(smem + T::STAGE * T::STAGES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM, z = blockIdx.z;
  int u0, u1;
  split_range(z, a.splits, a.K / (64 * T::NH * T::SPU), &u0, &u1);
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
    if (s < nq) ex_load<BITS, MT>(smem + s * T::STAGE, q0 + s, a, m0, n0);
    cp_async_commit();
  }
  for (int i = 0; i < nq; ++i) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1 and its pairs
    const int nxt = i + T::STAGES - 1;
    if (nxt < nq) ex_load<BITS, MT>(smem + (nxt % T::STAGES) * T::STAGE, q0 + nxt, a, m0, n0);
    cp_async_commit();
    const uint8_t* st = smem + (i % T::STAGES) * T::STAGE;
    ex_convert<BITS, MT>(st, conv, q0 + i, a);
    __syncthreads();  // the step's pairs are written
    ex_step<BITS, MT>(st, conv, acc, warp, g, t, a.gshift);
  }
  cp_async_wait<0>();

  float* out = a.splits == 1 ? a.y : a.ws + (size_t)z * a.M * a.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + warp * 32 + nt * 8 + 2 * t + (e & 1);
        if (r < a.M && col < a.N) out[(size_t)r * a.N + col] = acc[mt][nt][e];
      }
  if (a.splits > 1 && split_arrive_last(a.cnt, blockIdx.y * gridDim.x + blockIdx.x, a.splits))
    split_sum(a.ws, a.y, a.splits, (size_t)a.M * a.N, a.N, m0, min(T::BM, a.M - m0), n0,
              min(BN, a.N - n0));
}

template <int BITS, int MT>
static int launch(const ExArgs& a, cudaStream_t stream) {
  using T = ExTile<BITS, MT>;
  auto kern = exact_gemm_kernel<BITS, MT>;
  static bool sized = false;  // the attribute is set once a process
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + T::BM - 1) / T::BM, a.splits);
  kern<<<grid, THREADS, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}
}  // namespace

// x [M, K] bf16 (K = the repack's k_pad, zero-padded); codes [N, K * bits
// / 8] (int8 or uint8 codes, or 4- or 2-bit planes); g_scale [N, K /
// group] of dtype sdt (0 f32, 1 uint8, 2 int8); g_min the same layout of
// dtype mdt, or NULL; sb_scale, sb_min [N, K / 256] f32 or NULL (sb_min
// only with g_min and sb_scale); off the code offset; y [M, N] f32.  (bm,
// splits) from ops/cuda/qmm.py::plan over units of 64 elements (8-bit) or
// 256 (4- and 2-bit); ws [splits, M, N] f32 and cnt (one zeroed int a
// tile) when splits > 1.  Every pointer 16-byte aligned.
LK_API int lk_exact_dequant_gemm(const __nv_bfloat16* x, const uint8_t* codes, const void* gs,
                                 const void* gm, const float* sb, const float* sbm, float* y,
                                 int M, int N, int K, int bits, int group, int sdt, int mdt,
                                 float off, int bm, int splits, float* ws, int* cnt,
                                 cudaStream_t stream) {
  const int unit = bits == 8 ? 64 : 256;
  const bool dt_ok = sdt >= 0 && sdt <= 2 && (gm == nullptr || (mdt >= 0 && mdt <= 2));
  if (M <= 0 || N <= 0 || K <= 0 || K % 256 || (bits != 8 && bits != 4 && bits != 2) ||
      (group != 16 && group != 32) || !dt_ok || (sbm && (!gm || !sb)) ||
      (bm != 32 && bm != 64) || splits < 1 || splits > K / unit ||
      (splits > 1 && (!ws || !cnt || N % 4)))
    return (int)cudaErrorInvalidValue;
  const ExArgs a{x, codes, static_cast<const uint8_t*>(gs), static_cast<const uint8_t*>(gm),
                 sb, sbm, y, M, N, K, group == 16 ? 4 : 5, sdt, mdt, off, splits, ws, cnt};
  if (bits == 8) return bm == 32 ? launch<8, 2>(a, stream) : launch<8, 4>(a, stream);
  if (bits == 4) return bm == 32 ? launch<4, 2>(a, stream) : launch<4, 4>(a, stream);
  return bm == 32 ? launch<2, 2>(a, stream) : launch<2, 4>(a, stream);
}
