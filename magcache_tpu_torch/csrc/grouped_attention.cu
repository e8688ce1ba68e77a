// K5, K5r and K4: block-diagonal grouped attention, bf16, head dim 72, with
// an optional per-head RMS qk-norm and in-group RoPE fused into the q/k
// loads, and a fixed or a row-max softmax shift.
//
// Replaces magcache_tpu/ops/attention.py:grouped_attention_fused_qkv (K5;
// K5r is its call without gains and with the row max) and
// grouped_flash_attention_bshd (K4), both with the Pallas body
// _grouped_kernel. Token i attends exactly within its contiguous group
// i // group, to the keys at in-group positions < group_valid. q, k and v are
// [B, S, H, 72] read through their batch and token strides (unit channel
// stride, heads 72 apart): K4 gets three tensors, K5 three column views of
// one [B, S, 3*H*72] projection row. The output is [B, S, H*72].
//
// Math, point for point as the TPU kernel rounds it:
//   - q and k: with gains, RMS over the head's 72 values in f32 (sum of
//     squares / true_d), times rsqrt(var + eps), times the f32 gain; without
//     them, the bf16 values taken to f32; with RoPE, the interleaved-pair
//     rotation by the in-group position, in f32;
//   - q * (scale * log2(e)) in f32, rounded to bf16 once; k rounded to bf16;
//   - f32 scores; p = exp2(s - m) with m either the static shift (fixed max:
//     RMS-normed scores are bounded, p = exp2(min(s, m + 126) - m)) or each
//     row's max over the group's valid keys (row max, one-shot: the TPU
//     holds the whole group and takes the true max before any exp2);
//   - l sums the unrounded f32 p; p is rounded to bf16 before PV; the f32
//     accumulator is divided by l at the end and rounded to bf16.
//
// What bounds it on the H100: spatial attention at STDiT3-XL/2 480p is
// 30 frames x 16 heads x 1,590^2 x 72 x 4 = 350 GFLOP over 0.35 GB of qkv,
// and Latte-1's at 512x512 32 x 16 x 1,024^2 x 72 x 4 = 155 GFLOP: tensor-core
// bound. The temporal calls (groups of T = 15 or 16 frames, 3,180 or 2,048
// groups x 16 heads) are memory-bound passes of 0.3-0.45 GB.
//
// Three kernels, chosen by the arguments alone:
//   - the row max without gains or RoPE on groups of more than 16 tokens
//     (K5r spatial: Latte's frames; K4 with the same arguments) runs the
//     warp-specialised wgmma/TMA body of hopper_attention.cuh (head dim 80
//     = 72 + a zero pad the tensor map supplies; mode kRowMax: QK^T over the
//     group's keys once for each row's true max, then softmax and PV with
//     that shift, K streamed through the TMA ring twice). q is scaled in
//     shared memory after its copy: q * (scale*log2(e)) in f32, rounded once.
//     Its TMA maps are 5-D (column, head, in-group position, group, batch)
//     over the tensors' own byte strides, the position extent group (q) or
//     group_valid (k, v), so positions past them arrive as zeros;
//   - groups of up to 16 tokens (grouped_small_kernel): one warp takes one
//     whole group (up to 16 rows) and does the 16 x 16 score tile and the
//     16 x 72 output in a single k-step, four groups per block; a row's 16
//     scores sit in one quad of lanes, so its max is two shuffles;
//   - larger groups with gains or RoPE, fixed max or row max
//     (grouped_tiled_kernel, K5 spatial): a block takes 64 queries of one
//     group and loops over the group's keys in tiles of 64 (the TPU kernel
//     holds a whole group in VMEM; a 1,590-token group's K and V, 458 KB,
//     do not fit Hopper's 227 KB of shared memory). With the row max that
//     loop runs twice (QK^T alone for the max, then p and PV), which only
//     the callerless gains-or-RoPE row-max calls reach.
//
// What the mma.sync kernels' design does about it: head dim 72 is padded to
// 80 (five k16 steps) only in shared memory; rows are 88 elements (176 B) so
// ldmatrix and the fragment loads are conflict-free. q/k/v are strided
// 144-byte, 16-byte-aligned head rows: no split or pad copies. Two adjacent
// lanes load each head row and join their halves of the RMS sum with one
// shuffle; the RoPE pairs stay in registers, and a block keeps its head's
// gains in shared memory. S and P never leave registers (the S accumulator
// layout is P's A-operand layout), V comes in through ldmatrix.trans.

#include "hopper_attention.cuh"
#include "mma_tile.cuh"

namespace {

using mc::bf16;

constexpr int kD = mc::kHD;
constexpr int kDP = mc::kHDP;
constexpr int kStr = mc::kHStr;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;             // queries per block, keys per KV tile

struct Args {
  const bf16* q;        // [B, S, H, 72] through (batch, token) strides
  const bf16* k;
  const bf16* v;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;   // strides, in elements
  bf16* out;            // [n_groups * group, H*72]
  const float* qg;      // [H, 72], or null: no qk-norm
  const float* kg;
  const float* cos;     // [group, 36] or null
  const float* sin;
  int n_groups, gpb, H, group, gvalid, rowmax;    // gpb: groups per batch row
  float q_scale, inv_true_d, eps, m_const;
};

// Head h's row at in-group position pos of group grp.
__device__ __forceinline__ const bf16* head_row(const bf16* base, long long bs,
                                                long long ts, const Args& p, int grp,
                                                int pos, int h) {
  return base + (long long)(grp / p.gpb) * bs +
         ((long long)(grp % p.gpb) * p.group + pos) * ts + h * kD;
}

// Half a q or k head row, normed (with gains) [and rotated at in-group
// position pos] (mc::load_qk_norm_half); both lanes of the pair call it.
__device__ __forceinline__ void load_qk_half(bf16* dst, const bf16* src, bool valid,
                                             const float* gain, const Args& p,
                                             int pos, float mult, int half) {
  const int rp = valid ? pos : 0;
  const float* cs = p.cos ? p.cos + (size_t)rp * (kD / 2) : nullptr;
  const float* sn = p.sin ? p.sin + (size_t)rp * (kD / 2) : nullptr;
  mc::load_qk_norm_half(dst, src, valid, gain, p.inv_true_d, p.eps, cs, sn, mult,
                        half);
}

using mc::load_head_half;
using mc::store_head_rows;

// Groups of up to 16 tokens: warp w of block b takes group 4b + w whole.
__global__ void __launch_bounds__(kThreads)
grouped_small_kernel(Args p) {
  __shared__ __align__(16) bf16 smem[kWarps][3][16 * kStr];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y;
  if (grp >= p.n_groups) return;
  bf16* Qs = smem[warp][0];
  bf16* Ks = smem[warp][1];
  bf16* Vs = smem[warp][2];

  // lanes 2r and 2r + 1 take row r; keys past group_valid are masked
  const int r = lane >> 1, half = lane & 1;
  load_qk_half(Qs + r * kStr, head_row(p.q, p.q_bs, p.q_ts, p, grp, r, h), r < p.group,
               p.qg ? p.qg + h * kD : nullptr, p, r, p.q_scale, half);
  load_qk_half(Ks + r * kStr, head_row(p.k, p.k_bs, p.k_ts, p, grp, r, h), r < p.gvalid,
               p.kg ? p.kg + h * kD : nullptr, p, r, 1.f, half);
  load_head_half(Vs + r * kStr, head_row(p.v, p.v_bs, p.v_ts, p, grp, r, h),
                 r < p.gvalid, half);
  __syncwarp();

  uint32_t qf[kDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) mc::load_a_frag(qf[kk], Qs + kk * 16, kStr);
  float s[2][4];
  mc::qk_scores<2>(s, qf, Ks);
  float m[2] = {p.m_const, p.m_const};
  if (p.rowmax) {
    m[0] = m[1] = mc::kNegInf;
    mc::row_max_update<2>(s, m, 0, p.gvalid);
    m[0] = mc::quad_max(m[0]);
    m[1] = mc::quad_max(m[1]);
  }
  float acc[kDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};
  mc::shifted_softmax_pv<2>(s, l, acc, Vs, 0, p.gvalid, m);
  store_head_rows(p.out, (size_t)grp * p.group, p.group, acc, l, (size_t)p.H * kD,
                  h * kD);
}

// Larger groups with gains or RoPE: a block takes 64 queries of one group
// and loops over the group's valid keys in tiles of 64 (twice with the row
// max: first for the rows' max, then for p and PV).
__global__ void __launch_bounds__(kThreads)
grouped_tiled_kernel(Args p) {
  __shared__ __align__(16) bf16 Qs[kTile * kStr];
  __shared__ __align__(16) bf16 Ks[kTile * kStr];
  __shared__ __align__(16) bf16 Vs[kTile * kStr];
  const int q0 = blockIdx.x * kTile;        // first query, in-group position
  const int grp = blockIdx.y;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5;

  __shared__ float gains[2][kD];                   // q and k gains of head h
  const bool norm = p.qg != nullptr;
  if (norm)
    for (int i = threadIdx.x; i < 2 * kD; i += kThreads)
      gains[i / kD][i % kD] = (i < kD ? p.qg : p.kg)[h * kD + i % kD];
  __syncthreads();
  // threads 2i and 2i + 1 take row i of every tile
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  load_qk_half(Qs + row * kStr, head_row(p.q, p.q_bs, p.q_ts, p, grp, q0 + row, h),
               q0 + row < p.group, norm ? gains[0] : nullptr, p, q0 + row, p.q_scale,
               half);
  __syncthreads();
  uint32_t qf[kDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk)
    mc::load_a_frag(qf[kk], Qs + warp * 16 * kStr + kk * 16, kStr);

  const int n_tiles = (p.gvalid + kTile - 1) / kTile;
  float m[2] = {p.m_const, p.m_const};
  if (p.rowmax) {
    m[0] = m[1] = mc::kNegInf;
    for (int j = 0; j < n_tiles; ++j) {
      const int key = j * kTile + row;
      __syncthreads();        // every warp is done with the previous tile
      load_qk_half(Ks + row * kStr, head_row(p.k, p.k_bs, p.k_ts, p, grp, key, h),
                   key < p.gvalid, norm ? gains[1] : nullptr, p, key, 1.f, half);
      __syncthreads();
      float s[kTile / 8][4];
      mc::qk_scores<kTile / 8>(s, qf, Ks);
      mc::row_max_update<kTile / 8>(s, m, j * kTile, p.gvalid);
    }
    m[0] = mc::quad_max(m[0]);
    m[1] = mc::quad_max(m[1]);
  }

  float acc[kDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();          // every warp is done with the previous tile
    const int key = k0 + row;
    load_qk_half(Ks + row * kStr, head_row(p.k, p.k_bs, p.k_ts, p, grp, key, h),
                 key < p.gvalid, norm ? gains[1] : nullptr, p, key, 1.f, half);
    load_head_half(Vs + row * kStr, head_row(p.v, p.v_bs, p.v_ts, p, grp, key, h),
                   key < p.gvalid, half);
    __syncthreads();
    float s[kTile / 8][4];
    mc::qk_scores<kTile / 8>(s, qf, Ks);
    mc::shifted_softmax_pv<kTile / 8>(s, l, acc, Vs, k0, p.gvalid, m);
  }
  const int nrows = min(16, p.group - (q0 + warp * 16));
  store_head_rows(p.out, (size_t)grp * p.group + q0 + warp * 16, nrows, acc, l,
                  (size_t)p.H * kD, h * kD);
}

}  // namespace

extern "C" int mc_grouped_attention(
    const void* q, const void* k, const void* v, long long q_bs, long long q_ts,
    long long k_bs, long long k_ts, long long v_bs, long long v_ts, void* out,
    const void* qg, const void* kg, const void* cos, const void* sin, int n_groups,
    int gpb, int H, int group, int gvalid, int rowmax, float q_scale, float true_d,
    float eps, float m_const, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.q_bs = q_bs;
  a.q_ts = q_ts;
  a.k_bs = k_bs;
  a.k_ts = k_ts;
  a.v_bs = v_bs;
  a.v_ts = v_ts;
  a.out = static_cast<bf16*>(out);
  a.qg = static_cast<const float*>(qg);
  a.kg = static_cast<const float*>(kg);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.n_groups = n_groups;
  a.gpb = gpb;
  a.H = H;
  a.group = group;
  a.gvalid = gvalid;
  a.rowmax = rowmax;
  a.q_scale = q_scale;
  a.inv_true_d = 1.f / true_d;
  a.eps = eps;
  a.m_const = m_const;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group <= 16) {
    const dim3 grid((n_groups + kWarps - 1) / kWarps, H);
    grouped_small_kernel<<<grid, kThreads, 0, st>>>(a);
  } else {
    const dim3 grid((group + kTile - 1) / kTile, n_groups, H);
    grouped_tiled_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The row max without gains or RoPE, groups of more than 16 tokens: the
// wgmma/TMA body (hopper_attention.cuh, head dim 80, kRowMax) on q, k and v
// described by `maps` (ops/attention.py:grouped_tma_maps); out is
// [n_groups * group, H*72].
extern "C" int mc_grouped_attention_tma(const void* q, const void* k, const void* v,
                                        void* out, const long long* maps, int n_groups,
                                        int gpb, int H, int group, int gvalid,
                                        float q_scale, void* stream) {
  hopper::Args a{};
  a.o = static_cast<bf16*>(out);
  a.H = H;
  a.Sq = group;
  a.kv_len = gvalid;
  a.gpb = gpb;
  a.q_scale = q_scale;
  const dim3 grid((group + hopper::kBlockM - 1) / hopper::kBlockM, n_groups, H);
  return hopper::launch<80, hopper::kRowMax>(q, k, v, maps, a, grid,
                                             static_cast<cudaStream_t>(stream));
}
