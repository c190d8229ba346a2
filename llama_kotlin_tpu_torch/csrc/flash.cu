// Kernel 3: masked GQA attention over the bf16 cell cache, online softmax.
//
// Replaces llama_kotlin_tpu/ops/pallas/flash.py::flash_attention (bf16 KV,
// static layer index into the whole [L, KV, cells, D] cache, int8 mask
// bounding n_vis, logit softcap, fully masked rows give 0).
//
// Bound on the H100: bytes at decode (each K/V byte feeds ~4 query rows)
// and still bytes for a 64-token prefill over 512 cells, so the floor is
// one read of the visible K/V prefix.  Design: a block owns one kv head, a
// tile of 16 query rows of that head's GQA group (row r = token r / rep,
// head kvh * rep + r % rep, so K/V tiles are read once per group, not once
// per query head) and one contiguous split of the visible cells.  It walks
// 64-cell tiles with f32 online-softmax statistics in shared memory and an
// f32 accumulator per (row, dim) in registers (thread d owns dimension d).
// Splitting the cells over blocks (flash-decoding) fills the card at
// decode, where KV * row-tiles is only 8 blocks; a second kernel merges the
// splits' (m, l, acc) in a fixed order.  Requires head_dim == 128.
#include "common.cuh"

namespace {
constexpr int D = 128;        // head dim (one thread per dim)
constexpr int RT = 16;        // query rows per block
constexpr int CT = 64;        // cells per tile
constexpr int KSTR = D + 2;   // padded K row (bf16): 65 words, conflict-free
constexpr float NEG_INF = -1e30f;
}  // namespace

__global__ void __launch_bounds__(128)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
             const __nv_bfloat16* __restrict__ vc, const int8_t* __restrict__ mask,
             float* __restrict__ part_o, float* __restrict__ part_ml, int nt, int H, int KV,
             int cells, int n_vis, int layer, float scale, float softcap, int split_cells) {
  __shared__ float qs[RT][D];
  __shared__ __nv_bfloat16 ks[CT][KSTR];
  __shared__ __nv_bfloat16 vs[CT][D];
  __shared__ float ps[RT][CT];
  __shared__ int8_t vis[RT][CT];
  __shared__ float m_s[RT], l_s[RT], alpha_s[RT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, rep = H / KV, R = rep * nt;
  const int r0 = blockIdx.y * RT, split = blockIdx.z;
  const int c_begin = split * split_cells;
  const int c_end = min(n_vis, c_begin + split_cells);

  // q rows -> f32 shared memory; rows past R are zero (masked below)
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + i;
    float v = 0.f;
    if (r < R) {
      const int t = r / rep, h = kvh * rep + r % rep;
      v = __bfloat162float(q[((size_t)t * H + h) * D + tid]);
    }
    qs[i][tid] = v;
  }
  if (tid < RT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0.f;

  const size_t head_base = ((size_t)layer * KV + kvh) * cells;
  for (int c0 = c_begin; c0 < c_end; c0 += CT) {
    __syncthreads();  // previous tile fully consumed
    // K and V tiles: 64 cells x 128 dims, 4-byte words
    for (int idx = tid; idx < CT * D / 2; idx += 128) {
      const int c = idx / (D / 2), w = idx % (D / 2);
      const size_t off = (head_base + c0 + c) * D + 2 * w;
      *reinterpret_cast<__nv_bfloat162*>(&ks[c][2 * w]) =
          *reinterpret_cast<const __nv_bfloat162*>(kc + off);
      *reinterpret_cast<__nv_bfloat162*>(&vs[c][2 * w]) =
          *reinterpret_cast<const __nv_bfloat162*>(vc + off);
    }
    for (int idx = tid; idx < RT * CT; idx += 128) {
      const int i = idx / CT, c = idx % CT, r = r0 + i;
      vis[i][c] = (r < R) ? (mask[(size_t)(r / rep) * n_vis + c0 + c] != 0) : 0;
    }
    __syncthreads();

    // scores: thread -> cell tid % 64, rows 8 * (tid / 64) ...
    {
      const int c = tid % CT, i0 = (tid / CT) * 8;
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      for (int d = 0; d < D; d += 2) {
        const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ks[c][d]));
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += qs[i0 + i][d] * kk.x + qs[i0 + i][d + 1] * kk.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = s[i] * scale;
        if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
        ps[i0 + i][c] = vis[i0 + i][c] ? v : NEG_INF;
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
      ps[i][lane] = p0;
      ps[i][lane + 32] = p1;
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
  const size_t rows_total = (size_t)KV * R;
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + i;
    if (r >= R) break;
    const size_t row = (size_t)split * rows_total + (size_t)kvh * R + r;
    part_o[row * D + tid] = acc[i];
    if (tid == 0) {
      part_ml[2 * row] = m_s[i];
      part_ml[2 * row + 1] = l_s[i];
    }
  }
}

// Merge the splits of one (kv head, row) and write out[t, h, :] in bf16.
__global__ void __launch_bounds__(128)
flash_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   __nv_bfloat16* __restrict__ out, int nt, int H, int KV, int nsplit) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const int rep = H / KV, R = rep * nt;
  const size_t rows_total = (size_t)KV * R;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_ml[2 * (s * rows_total + row)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t pr = s * rows_total + row;
    const float w = expf(part_ml[2 * pr] - m);
    l += part_ml[2 * pr + 1] * w;
    o += part_o[pr * D + tid] * w;
  }
  const int kvh = row / R, r = row % R;
  const int t = r / rep, h = kvh * rep + r % rep;
  out[((size_t)t * H + h) * D + tid] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
}

// q [nt, H, 128] bf16; k/v cache [L, KV, cells, 128] bf16 (layer `layer`);
// mask [nt, n_vis] int8; out [nt, H, 128] bf16.  part_o [nsplit, KV*R, 128]
// and part_ml [nsplit, KV*R, 2] f32 are scratch, R = (H/KV) * nt.
LK_API int lk_flash(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const int8_t* mask, __nv_bfloat16* out, float* part_o, float* part_ml,
                    int nt, int H, int KV, int cells, int n_vis, int layer, float scale,
                    float softcap, int nsplit, cudaStream_t stream) {
  if (nt <= 0 || KV <= 0 || H % KV || n_vis <= 0 || n_vis % CT || n_vis > cells ||
      nsplit <= 0 || (n_vis / CT) % nsplit)
    return (int)cudaErrorInvalidValue;
  const int R = (H / KV) * nt;
  const int split_cells = n_vis / nsplit;
  flash_kernel<<<dim3(KV, (R + RT - 1) / RT, nsplit), 128, 0, stream>>>(
      q, k, v, mask, part_o, part_ml, nt, H, KV, cells, n_vis, layer, scale, softcap,
      split_cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_merge_kernel<<<KV * R, 128, 0, stream>>>(part_o, part_ml, out, nt, H, KV, nsplit);
  return (int)cudaGetLastError();
}
