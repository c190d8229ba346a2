// The staged W4A8 FFN of kernels 2 and 10 (qmm_w4_ffn.cu up to T2 rows,
// qmm_w4_layer.cu), run as one cooperative launch: every block resident,
// one a multiprocessor, stages separated by grid-wide barriers.
//
//   x, quantized per 256 in every block's shared memory (the caller's step)
//   1. g|u = W4A8(x) [gate; up]^T over the 2F rows    -> gu [B, 2F] f32
//   -- grid.sync
//   2. h = bf16(act(g) u), quantized per 256            -> h8, dh, hsum
//   -- grid.sync
//   3. every block copies h's codes into shared memory; y = W4A8(h) down^T
//      over the E rows, each output summed whole by one warp or block
//      (no partials across blocks, no atomics), handed to the caller's out().
//
// The activations of a stage sit in shared memory once a block, so a stage
// streams its weights once from device memory.  Each stage's rows take one of
// two products, chosen by the row count (T10, WALK_ROWS):
//   - the walk (B <= T10): w4_dot.cuh's warp-per-row dot, rows spread over
//     every warp of the grid;
//   - int8 tensor cores (B > T10): mma.sync m16n8k32 with 16 weight rows as
//     the A operand and the (at most 8) batch rows as the B operand, n = 8,
//     one product a 32-group, the exact int32 partial scaled as the walk
//     scales it (compact, legacy, SYM).  In the o and down stages a block
//     takes two 16-row groups at a time, KSPLIT warps split each group's K
//     in span ranges and the block sums their results in warp order; in
//     gate|up each warp takes whole groups.  Every weight byte is loaded
//     once, straight into registers.
// Tried and not kept (H100, kernel 2 at 8 rows): L2 prefetches of each
// warp's next group and of each stage's first rows before its barrier
// (cp.async.bulk.prefetch.L2; 0.0878 ms with them, 0.0769 without); the
// next span's codes and scales in registers (spills; 0.0744 against
// 0.0709); four superblocks a warp in flight in the in-block quantizer
// (below); four 512-byte steps of a walked row unrolled in place of
// w4_dot.cuh's two (one row: 0.0700 ms against 0.0532; three: 0.0533).
#pragma once

#include <cooperative_groups.h>

#include "mma_pipe.cuh"
#include "w4_dot.cuh"

namespace coop {
namespace cg = cooperative_groups;

// T10: stages of at most this many batch rows walk; more rows take the
// int8 tensor cores (the wrappers' COOP_WALK_ROWS).
constexpr int WALK_ROWS = 1;
constexpr int MAX_ROWS = 8;             // the mma's n; kernel 10's and the cooperative route's rows
constexpr int WARPS = 16, THREADS = WARPS * 32;
// warps that split one 16-row group's spans: 8 in the o and down stages
// (E / 16 = 256 groups for 132 blocks), none in gate|up (2F / 16 = 1792
// groups, about one a warp; measured 5% faster than 8 there at 2-8 rows)
constexpr int KSPLIT = 8, GU_KSPLIT = 1;

constexpr float kGeluC = 0.79788456080286535587989211986876f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// act(g): 0 silu, 1 gelu (tanh form), as the plain version computes it.
__device__ __forceinline__ float ffn_act(int act, float g) {
  return act == 0 ? g * (1.f / (1.f + expf(-g)))
                  : 0.5f * g * (1.f + tanhf(kGeluC * g * (1.f + 0.044715f * g * g)));
}

// Quantized activations in shared memory, NR rows of K elements: codes
// (row stride xld), superblock scales (sld) and group sums (gld).  The
// walk reads them at strides K, K/256, K/32 (w4_dot.cuh); the tensor-core
// product with PAD more (8-byte reads of 8 rows hit distinct banks).
struct Act {
  int8_t* x8;
  float* sx;
  int* xs;
  int xld, sld, gld;
};

// The block's shared memory: activations for K up to kmax, then the
// tensor cores' two reduction buffers, then kernel 10's norm sums.
template <int NR, bool MMA>
struct Smem {
  static constexpr int PAD = MMA ? 32 : 0, SPAD = MMA ? 4 : 0;
  __host__ __device__ static size_t x8_bytes(int kmax) { return (size_t)NR * (kmax + PAD); }
  __host__ __device__ static size_t sx_bytes(int kmax) {
    return (size_t)NR * (kmax / 256 + SPAD) * 4;
  }
  __host__ __device__ static size_t xs_bytes(int kmax) {
    return (size_t)NR * (kmax / 32 + SPAD) * 4;
  }
  static constexpr size_t RED = MMA ? 2 * WARPS * 128 * 4 : 0;
  static constexpr size_t NORM = (WARPS * NR + NR) * 4;
  __host__ __device__ static size_t bytes(int kmax) {
    return x8_bytes(kmax) + sx_bytes(kmax) + xs_bytes(kmax) + RED + NORM;
  }
  __device__ static Act act(uint8_t* base, int kmax, int k) {
    int8_t* x8 = reinterpret_cast<int8_t*>(base);
    float* sx = reinterpret_cast<float*>(base + x8_bytes(kmax));
    int* xs = reinterpret_cast<int*>(base + x8_bytes(kmax) + sx_bytes(kmax));
    return Act{x8, sx, xs, k + PAD, k / 256 + SPAD, k / 32 + SPAD};
  }
  __device__ static float* red(uint8_t* base, int kmax) {
    return reinterpret_cast<float*>(base + x8_bytes(kmax) + sx_bytes(kmax) + xs_bytes(kmax));
  }
  __device__ static float* norm(uint8_t* base, int kmax) {
    return reinterpret_cast<float*>(base + x8_bytes(kmax) + sx_bytes(kmax) + xs_bytes(kmax) +
                                    RED);
  }
};

// quantize8_sb (q8.cu's prologue) with the division of kernel 8's
// in-launch quantizer (common.cuh's norm_scale/recip_nb/div_nb): the same
// codes bit for bit, without __fdiv_rn's call for each element (every block
// quantizes all of its rows).
__device__ __forceinline__ float quantize8(const float v[8], int8_t out[8], int* gsum) {
  const float d = sb_scale(v);
  const float safe = d > 0.f ? d : 1.0f;
  const float scale = norm_scale(safe), dn = __fmul_rn(safe, scale), y = recip_nb(dn);
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = code8(div_nb(__fmul_rn(v[i], scale), dn, y));
    out[i] = (int8_t)q;
    sum += q;
  }
  *gsum = group_sum(sum);
  return d;
}

// B rows of K values quantized per 256 (q8.cu's prologue, bit for bit)
// into x, one warp a superblock: load8(b, e, v) gives the 8 values e.. of
// row b.  The tensor-core product reads the group sums as f32 (exact:
// |sum| <= 32 * 127), stored so here.  (Loading four superblocks a warp
// before quantizing them took kernel 2 from 0.053 to 0.069 ms at one row
// on the H100: not kept.)
template <bool MMA, class Load8>
__device__ __forceinline__ void quantize_rows(int B, int K, const Act& x, Load8 load8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, S = K / 256;
  for (int u = warp; u < B * S; u += WARPS) {
    const int b = u / S, s = u - b * S;
    float v[8];
    load8(b, s * 256 + lane * 8, v);
    __align__(8) int8_t q[8];
    int gsum;
    const float d = quantize8(v, q, &gsum);
    *reinterpret_cast<int2*>(x.x8 + b * x.xld + s * 256 + lane * 8) =
        *reinterpret_cast<const int2*>(q);
    if ((lane & 3) == 0)
      x.xs[b * x.gld + s * 8 + lane / 4] = MMA ? __float_as_int((float)gsum) : gsum;
    if (lane == 0) x.sx[b * x.sld + s] = d;
  }
}

// The 8 values e.. of an f32 row (16-byte aligned), and of a bf16 row.
__device__ __forceinline__ void load8_f32(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
}
__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p, float v[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The 8 group scales and mins of one row and span as the walk forms them:
// compact d sc6, dmin m6; legacy g_scale, g_min (+ 8 s on hi groups); SYM
// 8 s as the min of every group.
template <bool COMPACT, bool SYM>
__device__ __forceinline__ void row_scales(const W4Fold& w, int row, int s, int kc, float sc[8],
                                           float mn[8]) {
  if (COMPACT) {
    const size_t sb = (size_t)row * (kc / 128) + s;
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(w.q6 + sb * 16));
    const float2 d = __ldg(reinterpret_cast<const float2*>(w.dd + 2 * sb));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    // d sc6 as (2^23 + sc6) d - 2^23 d in one FMA: the exact product,
    // rounded once (byte_f: no int-to-float conversion)
    const float nd = -8388608.f * d.x, nm = -8388608.f * d.y;
#pragma unroll
    for (int gi = 0; gi < 8; ++gi) {
      sc[gi] = __fmaf_rn(byte_f(words[gi >> 2], gi & 3), d.x, nd);
      mn[gi] = __fmaf_rn(byte_f(words[2 + (gi >> 2)], gi & 3), d.y, nm);
    }
    return;
  }
  const size_t g = (size_t)row * (kc / 16) + s * 8;
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(w.gs + g));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(w.gs + g + 4));
  const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (!SYM) {
    const float4 m0 = __ldg(reinterpret_cast<const float4*>(w.gm + g));
    const float4 m1 = __ldg(reinterpret_cast<const float4*>(w.gm + g + 4));
    m[0] = m0.x, m[1] = m0.y, m[2] = m0.z, m[3] = m0.w;
    m[4] = m1.x, m[5] = m1.y, m[6] = m1.z, m[7] = m1.w;
  }
#pragma unroll
  for (int gi = 0; gi < 8; ++gi) {
    sc[gi] = v[gi];
    // SYM: 8 s on lo groups, 0 + 8 s on hi ones; legacy: g_min, + 8 s on hi
    mn[gi] = SYM ? 8.f * v[gi] : (gi >= 4 ? m[gi] + 8.f * v[gi] : m[gi]);
  }
}

// An 8-byte load of weight codes that asks L2 for the whole 256-byte
// sector pair: the next span of the same row, which the warp reads next.
__device__ __forceinline__ uint2 ld_codes(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L2::256B.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// Products of 16 weight rows row0.. of w (kc plane bytes a row) over spans
// [s0, s1) with batch rows 0..7 of x (rows >= B as zero codes), into
// c[e]: weight row row0 + g + 8 (e >> 1), batch row 2t + (e & 1).  Thread
// (g, t) loads code bytes 8t..8t+7 of each 32-byte chunk of rows g and
// g + 8 (the lo group's low nibbles and the hi group's high ones) and the
// same 8 activation bytes of batch row g: a permutation of k that both
// operands share, as in w4_mma.cuh.
template <bool COMPACT, bool SYM>
__device__ __forceinline__ void mma_rows(float c[4], const W4Fold& w, int row0, int kc, int s0,
                                         int s1, const Act& x, int B, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* ca = w.codes + (size_t)(row0 + g) * kc + t * 8;
  const uint8_t* cb = ca + (size_t)8 * kc;
  const bool live = g < B;
  const int8_t* xr = x.x8 + g * x.xld + t * 8;
  const float* xs0 = reinterpret_cast<const float*>(x.xs) + 2 * t * x.gld;
  const float* sx0 = x.sx + 2 * t * x.sld;
  for (int s = s0; s < s1; ++s) {
    uint2 wa[4], wb[4];
#pragma unroll
    for (int gp = 0; gp < 4; ++gp) {
      wa[gp] = ld_codes(ca + s * 128 + gp * 32);
      wb[gp] = ld_codes(cb + s * 128 + gp * 32);
    }
    float sa[8], ma[8], sb[8], mb[8];
    row_scales<COMPACT, SYM>(w, row0 + g, s, kc, sa, ma);
    row_scales<COMPACT, SYM>(w, row0 + g + 8, s, kc, sb, mb);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int gp = 0; gp < 4; ++gp) {
      const int8_t* xp = xr + s * 256 + gp * 32;
      const uint2 xl = live ? *reinterpret_cast<const uint2*>(xp) : make_uint2(0u, 0u);
      const uint2 xh = live ? *reinterpret_cast<const uint2*>(xp + 128) : make_uint2(0u, 0u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = gp + 4 * h;  // lo groups 0..3, hi groups 4..7
        uint32_t a[4];
        if (h == 0) {
          a[0] = wa[gp].x & 0x0F0F0F0Fu, a[1] = wb[gp].x & 0x0F0F0F0Fu;
          a[2] = wa[gp].y & 0x0F0F0F0Fu, a[3] = wb[gp].y & 0x0F0F0F0Fu;
        } else {
          a[0] = ((wa[gp].x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          a[1] = ((wb[gp].x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          a[2] = ((wa[gp].y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          a[3] = ((wb[gp].y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
        const uint32_t bf[2] = {h ? xh.x : xl.x, h ? xh.y : xl.y};
        int p[4];
        mma_s8_magic(p, a, bf);
        const float x0 = xs0[s * 8 + gi], x1 = xs0[x.gld + s * 8 + gi];
        part[0] = fmaf(sa[gi], exact_f(p[0]), part[0]);
        part[0] = fmaf(-ma[gi], x0, part[0]);
        part[1] = fmaf(sa[gi], exact_f(p[1]), part[1]);
        part[1] = fmaf(-ma[gi], x1, part[1]);
        part[2] = fmaf(sb[gi], exact_f(p[2]), part[2]);
        part[2] = fmaf(-mb[gi], x0, part[2]);
        part[3] = fmaf(sb[gi], exact_f(p[3]), part[3]);
        part[3] = fmaf(-mb[gi], x1, part[3]);
      }
    }
    const float f0 = sx0[s], f1 = sx0[x.sld + s];
    c[0] += f0 * part[0];
    c[1] += f1 * part[1];
    c[2] += f0 * part[2];
    c[3] += f1 * part[3];
  }
}

// The rows [0, R) of one stage: rows < r_lo of lo, the rest rows r - r_lo
// of hi (kernel 2's gate and up; o and down pass one fold twice).
struct Rows {
  W4Fold lo, hi;
  int r_lo, R, kc;
  __device__ const W4Fold& fold(int row) const { return row < r_lo ? lo : hi; }
  __device__ int local(int row) const { return row < r_lo ? row : row - r_lo; }
};


// One stage's products, out(b, row, v) for every batch row b < B and row
// of r, each v a whole sum.  On the tensor cores KS warps split each
// 16-row group's spans and the block sums them in warp order through a
// double buffer, one block barrier an iteration; with KS = 1 each warp
// takes whole groups and no barrier.
template <int NB, bool MMA, bool COMPACT, bool SYM, int KS = KSPLIT, class Out>
__device__ __forceinline__ void stage(const Rows& r, const Act& x, int B, float* red, Out out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (!MMA) {
    const int nwarps = gridDim.x * WARPS;
    for (int row = blockIdx.x * WARPS + warp; row < r.R; row += nwarps) {
      const W4Fold& w = r.fold(row);
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      w4_row_partial<NB, COMPACT, 1, SYM>(acc, x.x8, x.sx, x.xs, B, w.codes, w.q6, w.dd, w.gs,
                                          w.gm, r.local(row), r.kc, lane);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float v = warp_sum(acc[b]);
        if (lane == 0 && b < B) out(b, row, v);
      }
    }
  } else if constexpr (KS == 1) {
    const int g = lane >> 2, t = lane & 3;
    for (int grp = blockIdx.x * WARPS + warp; grp < r.R / 16; grp += gridDim.x * WARPS) {
      const int row0 = grp * 16;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows<COMPACT, SYM>(c, r.fold(row0), r.local(row0), r.kc, 0, r.kc / 128, x, B, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 2 * t + (e & 1);
        if (b < B) out(b, row0 + g + 8 * (e >> 1), c[e]);
      }
    }
  } else {
    constexpr int GROUPS = WARPS / KS;  // 16-row groups a block takes at a time
    const int n_groups = r.R / 16, slot = warp / KS;
    int s0, s1;
    split_range(warp % KS, KS, r.kc / 128, &s0, &s1);
    int buf = 0;
    for (int it = blockIdx.x; it * GROUPS < n_groups; it += gridDim.x, buf ^= 1) {
      const int grp = it * GROUPS + slot;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (grp < n_groups) {
        const int row0 = grp * 16;
        mma_rows<COMPACT, SYM>(c, r.fold(row0), r.local(row0), r.kc, s0, s1, x, B, lane);
      }
      float* rb = red + buf * (WARPS * 128);
      *reinterpret_cast<float4*>(rb + warp * 128 + lane * 4) =
          make_float4(c[0], c[1], c[2], c[3]);
      __syncthreads();
      if (threadIdx.x < GROUPS * 128) {
        const int sl = threadIdx.x >> 7, idx = threadIdx.x & 127;
        const int grp2 = it * GROUPS + sl;
        float v = 0.f;
#pragma unroll
        for (int z = 0; z < KS; ++z) v += rb[(sl * KS + z) * 128 + idx];
        const int ln = idx >> 2, e = idx & 3;
        const int row = grp2 * 16 + (ln >> 2) + 8 * (e >> 1), b = 2 * (ln & 3) + (e & 1);
        if (grp2 < n_groups && b < B) out(b, row, v);
      }
    }
  }
}

// Scratch carved from one workspace, each piece 256-byte aligned (a null
// base only counts the bytes).
struct Carve {
  uint8_t* base;
  size_t bytes = 0;
  template <class T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + bytes) : nullptr;
    bytes += (count * sizeof(T) + 255) & ~(size_t)255;
    return p;
  }
};

// The FFN's folds, shapes and global scratch.
struct Ffn {
  W4Fold gate, up, dn;  // gate [F, E], up [F, E], down [E, F]
  int B, E, F, act;
  float* gu;    // [B, 2F]: g | u
  int8_t* h8;   // [B, F]
  float* dh;    // [B, F/256]
  int* hsum;    // [B, F/32]
  // h8, dh, hsum and gu from c (B, F set)
  void take_scratch(Carve& c) {
    h8 = c.take<int8_t>((size_t)B * F);
    dh = c.take<float>((size_t)B * (F / 256));
    hsum = c.take<int>((size_t)B * (F / 32));
    gu = c.take<float>((size_t)B * 2 * F);
  }
  __device__ Rows gate_up() const { return Rows{gate, up, F, 2 * F, E / 2}; }
  __device__ Rows down() const { return Rows{dn, dn, E, E, F / 2}; }
};

// Stages 1-3 for activations x (K = E) already quantized in the block's
// shared memory.
template <int NB, bool MMA, bool COMPACT, bool SYM, class Out>
__device__ __forceinline__ void ffn(const Ffn& a, uint8_t* smem, int kmax, cg::grid_group& grid,
                                    Out out) {
  using SM = Smem<MMA ? MAX_ROWS : NB, MMA>;
  const int B = a.B, E = a.E, F = a.F, S_F = F / 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* red = SM::red(smem, kmax);
  const Act x = SM::act(smem, kmax, E);
  stage<NB, MMA, COMPACT, SYM, GU_KSPLIT>(a.gate_up(), x, B, red,
                               [&](int b, int row, float v) { a.gu[(size_t)b * 2 * F + row] = v; });
  grid.sync();

  // 2. h, one warp a (batch row, superblock)
  const int nwarps = gridDim.x * WARPS;
  for (int u = blockIdx.x * WARPS + warp; u < B * S_F; u += nwarps) {
    const int b = u / S_F, f = u - b * S_F;
    const float* gp = a.gu + (size_t)b * 2 * F + f * 256 + lane * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      const float4 g4 = __ldcg(reinterpret_cast<const float4*>(gp + i));
      const float4 u4 = __ldcg(reinterpret_cast<const float4*>(gp + F + i));
      v[i] = bf16_round(ffn_act(a.act, g4.x) * u4.x);
      v[i + 1] = bf16_round(ffn_act(a.act, g4.y) * u4.y);
      v[i + 2] = bf16_round(ffn_act(a.act, g4.z) * u4.z);
      v[i + 3] = bf16_round(ffn_act(a.act, g4.w) * u4.w);
    }
    __align__(8) int8_t q[8];
    int gsum;
    const float d = quantize8(v, q, &gsum);
    *reinterpret_cast<int2*>(a.h8 + (size_t)b * F + f * 256 + lane * 8) =
        *reinterpret_cast<const int2*>(q);
    if ((lane & 3) == 0) a.hsum[(size_t)b * (F / 32) + f * 8 + lane / 4] = gsum;
    if (lane == 0) a.dh[b * S_F + f] = d;
  }
  grid.sync();

  // 3. h into shared memory, then the down rows
  const Act hx = SM::act(smem, kmax, F);
  for (int i = threadIdx.x; i < B * (F / 16); i += THREADS) {
    const int b = i / (F / 16), c = i - b * (F / 16);
    *reinterpret_cast<int4*>(hx.x8 + b * hx.xld + c * 16) =
        __ldcg(reinterpret_cast<const int4*>(a.h8 + (size_t)b * F + c * 16));
  }
  for (int i = threadIdx.x; i < B * (F / 32); i += THREADS) {
    const int b = i / (F / 32), c = i - b * (F / 32);
    const int v = __ldcg(a.hsum + (size_t)b * (F / 32) + c);
    hx.xs[b * hx.gld + c] = MMA ? __float_as_int((float)v) : v;
  }
  for (int i = threadIdx.x; i < B * S_F; i += THREADS) {
    const int b = i / S_F, c = i - b * S_F;
    hx.sx[b * hx.sld + c] = __ldcg(a.dh + b * S_F + c);
  }
  __syncthreads();
  stage<NB, MMA, COMPACT, SYM>(a.down(), hx, B, red, out);
}

// One cooperative launch of kern(args) over every SM (as many blocks an
// SM as fit), with smem bytes of dynamic shared memory.
template <class Args>
inline int launch(void (*kern)(Args), const Args& args, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((err = lk_sm_count(&sms)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  // every block must be resident at once for the grid barriers
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* argv[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms * per_sm), dim3(THREADS), argv,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// L<NB, MMA, COMPACT, SYM>::run(a, stream) for B rows (the walk's
// batch-row buckets up to T10, else the tensor cores) and the flavor.
template <template <int, bool, bool, bool> class L, int NB, bool MMA, class Args>
inline int run_flavor(const Args& a, int compact, int sym, cudaStream_t stream) {
  if (compact) return L<NB, MMA, true, false>::run(a, stream);
  return sym ? L<NB, MMA, false, true>::run(a, stream) : L<NB, MMA, false, false>::run(a, stream);
}

template <template <int, bool, bool, bool> class L, class Args>
inline int dispatch(const Args& a, int B, int compact, int sym, cudaStream_t stream) {
  if (B < 1 || B > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (B > WALK_ROWS) return run_flavor<L, MAX_ROWS, true>(a, compact, sym, stream);
  if constexpr (WALK_ROWS >= 1)
    if (B == 1) return run_flavor<L, 1, false>(a, compact, sym, stream);
  if constexpr (WALK_ROWS >= 2)
    if (B == 2) return run_flavor<L, 2, false>(a, compact, sym, stream);
  if constexpr (WALK_ROWS >= 3)
    if (B <= 4) return run_flavor<L, 4, false>(a, compact, sym, stream);
  if constexpr (WALK_ROWS >= 5) return run_flavor<L, 8, false>(a, compact, sym, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace coop
