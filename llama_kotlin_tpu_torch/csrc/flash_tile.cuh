// Flash attention over one layer of the cell cache by a walk of scalar
// f32 products: kernel 9 (flash_stacked.cu), and the pieces kernel 3's
// tensor-core tile (flash_mma.cuh) shares with it (the arguments, the
// constants, the merge of the splits).  Masked GQA online softmax over the
// [L, KV, cells, 128] cache, bf16 rows or int8 codes with one f32 scale
// per cached row ([L, KV, cells] planes), plus kernel 9's fresh rows.
//
// Bound on the H100: bytes at decode (each K/V byte feeds ~4 query rows)
// and still bytes for a 64-token prefill over 512-1024 cells, so the floor
// is one read of the visible K/V prefix (and its scales): per cached row
// and plane 256 bytes in bf16, 128 + 4 in int8.  Design: a block owns one
// kv head, a tile of 16 query rows of that head's GQA group (row r = token
// r / rep, head kvh * rep + r % rep, so K/V tiles are read once per group,
// not once per query head) and one contiguous split of the visible cells.
// It walks 64-cell tiles with f32 online-softmax statistics in shared
// memory and an f32 accumulator per (row, dim) in registers (thread d owns
// dimension d).  Splitting the cells over blocks (flash-decoding) fills
// the card at decode, where KV * row-tiles is only 8 blocks; a second
// kernel merges the splits' (m, l, acc) in a fixed order.
//
// int8 cache: codes are widened to bf16 in shared memory (|code| <= 127 is
// exact in bf16), so the tile arithmetic is the bf16 cache's; as in the
// Pallas kernel, the per-cell K scale multiplies the score after the
// softmax scale, s = (q . codes) * scale * ks[c], and the per-cell V scale
// folds into p after the running sum l takes it, before P V.
//
// Kernel 9's fresh rows ([nt, KV, 128] bf16, token-major) are one more
// split: the block of split index n_old walks them under mask_new
// [nt, nt] instead of walking cache cells under mask [nt, n_vis].
// Requires head_dim == 128.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {  // internal linkage: each .cu that includes this has its own copy

constexpr int FD = 128;       // head dim (one thread per dim)
constexpr int NTHR = FD;      // threads per block
constexpr int RT = 16;        // query rows per block
constexpr int CT = 64;        // cells per tile
constexpr int KSTR = FD + 2;  // padded K row (bf16): 65 words, conflict-free
constexpr float FLASH_NEG_INF = -1e30f;

struct FlashArgs {
  const __nv_bfloat16* q;   // [nt, H, D]
  const void* kc;           // [L, KV, cells, D] bf16 or int8 codes
  const void* vc;
  const float* ks;          // [L, KV, cells] f32 row scales (int8 cache) or null
  const float* vs;
  const int8_t* mask;       // [nt, n_vis]
  const __nv_bfloat16* kn;  // [nt, KV, D] fresh rows (kernel 9) or null
  const __nv_bfloat16* vn;
  const int8_t* mask_new;   // [nt, nt] (kernel 9)
  float* part_o;            // [splits, KV * R, D] scratch, R = (H / KV) * nt
  float* part_ml;           // [splits, KV * R, 2]
  int nt, H, KV, cells, n_vis, layer;
  float scale, softcap;
  int split_cells;          // cells per cache split
  int n_old;                // cache splits; split n_old is the fresh rows' split
};

// One 64-cell tile of the cache's K and V rows into shared memory as bf16.
// The loops stride by the constant block size, so the compiler unrolls them
// and keeps several loads in flight.
__device__ __forceinline__ void load_cache_tile(const __nv_bfloat16* __restrict__ kc,
                                                const __nv_bfloat16* __restrict__ vc,
                                                size_t row0, __nv_bfloat16 (*ks)[KSTR],
                                                __nv_bfloat16 (*vs)[FD]) {
  for (int idx = threadIdx.x; idx < CT * FD / 2; idx += NTHR) {
    const int c = idx / (FD / 2), w = idx % (FD / 2);
    const size_t off = (row0 + c) * FD + 2 * w;
    *reinterpret_cast<__nv_bfloat162*>(&ks[c][2 * w]) =
        *reinterpret_cast<const __nv_bfloat162*>(kc + off);
    *reinterpret_cast<__nv_bfloat162*>(&vs[c][2 * w]) =
        *reinterpret_cast<const __nv_bfloat162*>(vc + off);
  }
}

__device__ __forceinline__ void widen4(char4 c, __nv_bfloat16* dst) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn((float)c.x, (float)c.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn((float)c.z, (float)c.w);
}

__device__ __forceinline__ void load_cache_tile(const int8_t* __restrict__ kc,
                                                const int8_t* __restrict__ vc, size_t row0,
                                                __nv_bfloat16 (*ks)[KSTR],
                                                __nv_bfloat16 (*vs)[FD]) {
  for (int idx = threadIdx.x; idx < CT * FD / 4; idx += NTHR) {
    const int c = idx / (FD / 4), w = idx % (FD / 4);
    const size_t off = (row0 + c) * FD + 4 * w;
    widen4(*reinterpret_cast<const char4*>(kc + off), &ks[c][4 * w]);
    widen4(*reinterpret_cast<const char4*>(vc + off), &vs[c][4 * w]);
  }
}

// Fresh rows c0 .. c0+63 of kv head kvh (rows past nt read as 0).
__device__ __forceinline__ void load_fresh_tile(const FlashArgs& a, int kvh, int c0,
                                                __nv_bfloat16 (*ks)[KSTR],
                                                __nv_bfloat16 (*vs)[FD]) {
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int idx = threadIdx.x; idx < CT * FD / 2; idx += NTHR) {
    const int c = idx / (FD / 2), w = idx % (FD / 2), t = c0 + c;
    __nv_bfloat162 kk = zero, vv = zero;
    if (t < a.nt) {
      const size_t off = ((size_t)t * a.KV + kvh) * FD + 2 * w;
      kk = *reinterpret_cast<const __nv_bfloat162*>(a.kn + off);
      vv = *reinterpret_cast<const __nv_bfloat162*>(a.vn + off);
    }
    *reinterpret_cast<__nv_bfloat162*>(&ks[c][2 * w]) = kk;
    *reinterpret_cast<__nv_bfloat162*>(&vs[c][2 * w]) = vv;
  }
}

// T: the cache element, __nv_bfloat16 or int8_t (with row scales).
// STACKED: kernel 9, whose last split walks the fresh rows (the only
// instantiation since kernel 3 took its own tile, flash_mma.cuh).
template <typename T, bool STACKED>
__global__ void __launch_bounds__(NTHR) flash_split_kernel(const FlashArgs a) {
  __shared__ float qs[RT][FD];
  __shared__ __nv_bfloat16 ks[CT][KSTR];
  __shared__ __nv_bfloat16 vs[CT][FD];
  __shared__ float ps[RT][CT];
  __shared__ int8_t vis[RT][CT];
  __shared__ float ksc[CT], vsc[CT];
  __shared__ float m_s[RT], l_s[RT], alpha_s[RT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, rep = a.H / a.KV, R = rep * a.nt;
  const int r0 = blockIdx.y * RT, split = blockIdx.z;
  const bool fresh = STACKED && split == a.n_old;
  const bool quant = std::is_same<T, int8_t>::value && !fresh;
  const int c_begin = fresh ? 0 : split * a.split_cells;
  const int c_end = fresh ? a.nt : min(a.n_vis, c_begin + a.split_cells);
  const int8_t* __restrict__ mask = fresh ? a.mask_new : a.mask;
  const __nv_bfloat16* __restrict__ q = a.q;
  const int mask_cols = fresh ? a.nt : a.n_vis;

  // q rows -> f32 shared memory; rows past R are zero (masked below)
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + i;
    float v = 0.f;
    if (r < R) {
      const int t = r / rep, h = kvh * rep + r % rep;
      v = __bfloat162float(q[((size_t)t * a.H + h) * FD + tid]);
    }
    qs[i][tid] = v;
  }
  if (tid < RT) {
    m_s[tid] = FLASH_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0.f;

  const size_t head_base = ((size_t)a.layer * a.KV + kvh) * a.cells;
  for (int c0 = c_begin; c0 < c_end; c0 += CT) {
    __syncthreads();  // previous tile fully consumed
    if (fresh) {
      load_fresh_tile(a, kvh, c0, ks, vs);
    } else {
      load_cache_tile(static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
                      head_base + c0, ks, vs);
      if (quant && tid < CT) {
        ksc[tid] = a.ks[head_base + c0 + tid];
        vsc[tid] = a.vs[head_base + c0 + tid];
      }
    }
    for (int idx = tid; idx < RT * CT; idx += NTHR) {
      const int i = idx / CT, c = idx % CT, r = r0 + i;
      vis[i][c] = (r < R && (!fresh || c0 + c < c_end))
                      ? (mask[(size_t)(r / rep) * mask_cols + c0 + c] != 0)
                      : 0;
    }
    __syncthreads();

    // scores: thread -> cell tid % 64, rows 8 * (tid / 64) ...
    {
      const int c = tid % CT, i0 = (tid / CT) * 8;
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      for (int d = 0; d < FD; d += 2) {
        const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ks[c][d]));
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += qs[i0 + i][d] * kk.x + qs[i0 + i][d + 1] * kk.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = s[i] * a.scale;
        if (quant) v *= ksc[c];
        if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
        ps[i0 + i][c] = vis[i0 + i][c] ? v : FLASH_NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 4w .. 4w+3
    for (int i = warp * 4; i < warp * 4 + 4; ++i) {
      const float s0 = ps[i][lane], s1 = ps[i][lane + 32];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = vis[i][lane] ? expf(s0 - m_new) : 0.f;
      const float p1 = vis[i][lane + 32] ? expf(s1 - m_new) : 0.f;
      // the V scale folds into p only after l has taken the unscaled p
      ps[i][lane] = quant ? p0 * vsc[lane] : p0;
      ps[i][lane + 32] = quant ? p1 * vsc[lane + 32] : p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + psum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V (thread owns dimension tid)
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] *= alpha_s[i];
    for (int c = 0; c < CT; ++c) {
      const float v = __bfloat162float(vs[c][tid]);
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] += ps[i][c] * v;
    }
  }
  __syncthreads();

  // this split's (acc, m, l) per row of the [KV * R] row space
  const size_t rows_total = (size_t)a.KV * R;
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + i;
    if (r >= R) break;
    const size_t row = (size_t)split * rows_total + (size_t)kvh * R + r;
    a.part_o[row * FD + tid] = acc[i];
    if (tid == 0) {
      a.part_ml[2 * row] = m_s[i];
      a.part_ml[2 * row + 1] = l_s[i];
    }
  }
}

// Merge the splits of one (kv head, row) and write out[t, h, :] in bf16;
// a row that sees no cell gets 0.
__global__ void __launch_bounds__(NTHR)
flash_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   __nv_bfloat16* __restrict__ out, int nt, int H, int KV, int nsplit) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const int rep = H / KV, R = rep * nt;
  const size_t rows_total = (size_t)KV * R;
  float m = FLASH_NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_ml[2 * (s * rows_total + row)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t pr = s * rows_total + row;
    const float w = expf(part_ml[2 * pr] - m);
    l += part_ml[2 * pr + 1] * w;
    o += part_o[pr * FD + tid] * w;
  }
  const int kvh = row / R, r = row % R;
  const int t = r / rep, h = kvh * rep + r % rep;
  out[((size_t)t * H + h) * FD + tid] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
}

}  // namespace
