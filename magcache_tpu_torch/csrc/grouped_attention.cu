// K5: block-diagonal grouped attention read in place from the fused QKV
// projection, with per-head RMS qk-norm and optional in-group RoPE fused
// into the q/k loads. bf16, head dim 72.
//
// Replaces magcache_tpu/ops/attention.py:grouped_attention_fused_qkv
// (Pallas body _grouped_kernel). qkv is [B, S, 3*H*72] with columns q|k|v by
// head; token i attends exactly within its contiguous group i // group, to
// the keys at in-group positions < group_valid. The output is [B, S, H*72].
//
// Math, point for point as the TPU kernel rounds it:
//   - q and k: RMS over the head's 72 values in f32 (sum of squares / true_d),
//     times rsqrt(var + eps), times the f32 gain; with RoPE, the
//     interleaved-pair rotation by the in-group position, in f32;
//   - q * (scale * log2(e)) rounded to bf16; k rounded to bf16;
//   - f32 scores; p = exp2(min(s, m + 126) - m) with the static shift m
//     (fixed max: RMS-normed scores are bounded, so there is no row max and
//     no rescale, and a KV loop inside a group is exact);
//   - l sums the unrounded f32 p; p is rounded to bf16 before PV; the f32
//     accumulator is divided by l at the end and rounded to bf16.
//
// What bounds it on the H100: spatial attention at STDiT3-XL/2 480p is
// 30 frames x 16 heads x 1,590^2 x 72 x 4 = 350 GFLOP over 0.35 GB of qkv:
// tensor-core bound. The TPU kernel holds a whole 1,590-token group in
// VMEM; a group's K and V (458 KB) do not fit Hopper's 227 KB of shared
// memory, so a block takes 64 queries of one group and loops over the
// group's keys in tiles of 64 (the fixed max makes that loop exact). The
// temporal call (groups of T = 15 frames, 3,180 groups x 16 heads) is a
// memory-bound pass of 0.44 GB: there one warp takes one whole group
// (16 rows, the last one empty) and does the 16 x 16 score tile and the
// 16 x 72 output in a single k-step, four groups per block.
//
// What the design does about it: head dim 72 is padded to 80 (five k16
// steps) only in shared memory; rows are 88 elements (176 B) so ldmatrix and
// the fragment loads are conflict-free. q/k/v are strided reads of one
// [., 3*H*72] row (144-byte, 16-byte-aligned head rows): no split copies.
// Two adjacent lanes load each head row and join their halves of the RMS
// sum with one shuffle; the RoPE pairs stay in registers, and a block keeps
// its head's gains in shared memory. S and P never leave registers (the S
// accumulator layout is P's A-operand layout), V comes in through
// ldmatrix.trans. No cp.async/TMA pipeline yet.

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
  const bf16* qkv;      // [rows, 3*H*72]
  bf16* out;            // [rows, H*72]
  const float* qg;      // [H, 72]
  const float* kg;      // [H, 72]
  const float* cos;     // [group, 36] or null
  const float* sin;
  int n_groups, H, group, gvalid;
  float q_scale, inv_true_d, eps, m_const;
};

// Half a q or k head row, normed [and rotated at in-group position pos]
// (mc::load_qk_norm_half); both lanes of the pair call it.
__device__ __forceinline__ void load_qk_half(bf16* dst, const bf16* src, bool valid,
                                             const float* gain, const Args& p,
                                             int pos, float mult, int half) {
  const int rp = valid ? pos : 0;
  const float* cs = p.cos ? p.cos + (size_t)rp * (kD / 2) : nullptr;
  const float* sn = p.sin ? p.sin + (size_t)rp * (kD / 2) : nullptr;
  mc::load_qk_norm_half(dst, src, valid, gain, p.inv_true_d, p.eps, cs, sn, mult,
                        half);
}

using mc::fixed_max_softmax_pv;
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
  const size_t ld = (size_t)3 * p.H * kD;
  const size_t row0 = (size_t)grp * p.group;
  const bf16* base = p.qkv + row0 * ld + h * kD;

  // lanes 2r and 2r + 1 take row r; keys past group_valid are masked
  const int r = lane >> 1, half = lane & 1;
  load_qk_half(Qs + r * kStr, base + r * ld, r < p.group, p.qg + h * kD, p, r,
               p.q_scale, half);
  load_qk_half(Ks + r * kStr, base + r * ld + p.H * kD, r < p.gvalid, p.kg + h * kD,
               p, r, 1.f, half);
  load_head_half(Vs + r * kStr, base + r * ld + 2 * p.H * kD, r < p.gvalid, half);
  __syncwarp();

  uint32_t qf[kDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) mc::load_a_frag(qf[kk], Qs + kk * 16, kStr);
  float s[2][4];
  mc::qk_scores<2>(s, qf, Ks);
  float acc[kDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};
  fixed_max_softmax_pv<2>(s, l, acc, Vs, 0, p.gvalid, p.m_const);
  store_head_rows(p.out, row0, p.group, acc, l, (size_t)p.H * kD, h * kD);
}

// Larger groups: a block takes 64 queries of one group and loops over the
// group's valid keys in tiles of 64.
__global__ void __launch_bounds__(kThreads)
grouped_tiled_kernel(Args p) {
  __shared__ __align__(16) bf16 Qs[kTile * kStr];
  __shared__ __align__(16) bf16 Ks[kTile * kStr];
  __shared__ __align__(16) bf16 Vs[kTile * kStr];
  const int q0 = blockIdx.x * kTile;        // first query, in-group position
  const int grp = blockIdx.y;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const size_t ld = (size_t)3 * p.H * kD;
  const size_t row0 = (size_t)grp * p.group;
  const bf16* base = p.qkv + row0 * ld + h * kD;

  __shared__ float gains[2][kD];                   // q and k gains of head h
  for (int i = threadIdx.x; i < 2 * kD; i += kThreads)
    gains[i / kD][i % kD] = (i < kD ? p.qg : p.kg)[h * kD + i % kD];
  __syncthreads();
  // threads 2i and 2i + 1 take row i of every tile
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  load_qk_half(Qs + row * kStr, base + (q0 + row) * ld, q0 + row < p.group, gains[0],
               p, q0 + row, p.q_scale, half);
  __syncthreads();
  uint32_t qf[kDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk)
    mc::load_a_frag(qf[kk], Qs + warp * 16 * kStr + kk * 16, kStr);

  float acc[kDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};
  const int n_tiles = (p.gvalid + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();          // every warp is done with the previous tile
    const int key = k0 + row;
    load_qk_half(Ks + row * kStr, base + key * ld + p.H * kD, key < p.gvalid,
                 gains[1], p, key, 1.f, half);
    load_head_half(Vs + row * kStr, base + key * ld + 2 * p.H * kD, key < p.gvalid, half);
    __syncthreads();
    float s[kTile / 8][4];
    mc::qk_scores<kTile / 8>(s, qf, Ks);
    fixed_max_softmax_pv<kTile / 8>(s, l, acc, Vs, k0, p.gvalid, p.m_const);
  }
  const int nrows = min(16, p.group - (q0 + warp * 16));
  store_head_rows(p.out, row0 + q0 + warp * 16, nrows, acc, l, (size_t)p.H * kD,
                  h * kD);
}

}  // namespace

extern "C" int mc_grouped_attention_fused_qkv(
    const void* qkv, void* out, const void* qg, const void* kg,
    const void* cos, const void* sin, int rows, int H, int group, int gvalid,
    float q_scale, float true_d, float eps, float m_const, void* stream) {
  Args a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.out = static_cast<bf16*>(out);
  a.qg = static_cast<const float*>(qg);
  a.kg = static_cast<const float*>(kg);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.n_groups = rows / group;
  a.H = H;
  a.group = group;
  a.gvalid = gvalid;
  a.q_scale = q_scale;
  a.inv_true_d = 1.f / true_d;
  a.eps = eps;
  a.m_const = m_const;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group <= 16) {
    const dim3 grid((a.n_groups + kWarps - 1) / kWarps, H);
    grouped_small_kernel<<<grid, kThreads, 0, st>>>(a);
  } else {
    const dim3 grid((group + kTile - 1) / kTile, a.n_groups, H);
    grouped_tiled_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
