// K2, K3 and K3p, and K7's operand pass: one row-resident body for the
// normalisations in front of attention and of the DiT projections.
//
// K3 replaces magcache_tpu/ops/fused_prologue.py:layer_norm_mod (Pallas
// body _ln_mod_kernel) in its three modes, with the TPU kernel's rounding
// points: a two-pass f32 LayerNorm (the mean, then the mean of the squared
// centred values), y = (x - mean) * reciprocal(sqrt(var + eps)), correctly
// rounded (not rsqrtf), then
//   mod:    bf16(bf16(y) * (1 + scale) + shift), scale/shift the f32 rows of
//           the token's sample;
//   affine: bf16(y * w + b);
//   plain:  bf16(y)  (K3p);
// the f32 multiply-adds fused (one rounding where the plain version rounds
// the product first: at most an f32 ulp before the bf16 rounding).
// K7's operand (magcache_tpu/ops/fused_prologue.py:lnmod_matmul, Pallas body
// _lnmod_mm_kernel: the GEMM operand that hopper_gemm.cuh multiplies) keeps
// its own statistic, rsqrtf, and its fused multiply-add:
//   bf16(bf16((x - mean) * rsqrtf(var + eps)) * (1 + scale) + shift), with
// 1 + scale from the host and modulation row b / batch_repeat. The sums run
// in the order of the kernel it replaces (ln_modulate_kernel, kept as
// tools/ln_modulate_parent.cu), so K7's output is bit-equal to it. The statistic is a template choice; the two
// formulas are not merged, since the two TPU kernels differ in it.
// K2 replaces magcache_tpu/ops/fused_prologue.py:rms_norm_rope (Pallas body
// _kernel): RMSNorm with the f32 mean of squares over the whole H*128 row
// (token scope, Wan) or over each head's 128 channels (head scope, FLUX,
// HunyuanVideo, Qwen-Image), y = x * reciprocal(sqrt(ms + eps)) * gain
// rounded to bf16, then the interleaved-pair RoPE rotation in f32
// (ye * cos - yo * sin, ye * sin + yo * cos, each a product and a fused
// multiply-add), one rounding at the store,
// written as a contiguous [B, S, H, 128]. Rows are read through a batch and
// a token stride, so a q or k column slice of a fused projection (FLUX's
// rows of 9,216, HunyuanVideo's single-block rows of 21,504) is read in
// place.
//
// Under tensor parallelism a rank holds H/tp heads of Wan's token-scope row,
// and the norm runs over the whole H*128. K2 then runs in two passes (the
// JAX package lets XLA reduce the sum of squares across the sharded axis,
// magcache_tpu/ops/fused_prologue.py:370-377):
//   stats (row_sumsq_kernel): the f32 sum of squares of the rank's slice of
//          each row, [B, S] (summed as K2's token scope sums: four partial
//          sums a lane, one a word, then across the warp);
//   apply (rms_norm_rope_kernel with EXT): after the caller's all-reduce of
//          those sums over tp, K2 reads the row's total in place of its own
//          reduction and divides it by the whole row's width.
// The tp widths (MC_TP_ROW_WIDTHS: 384 to 2,560) are compile-time instances of
// both passes.
//
// What bounds them on the H100: each reads a row of 1,152 to 5,120 bf16
// values once and writes it once, with about 8 f32 operations a value, so
// HBM bandwidth (3.35 TB/s) is the limit at the main path's shapes: Wan's
// 2 x 32,760 x 1,536 is 0.40 GB, 0.120 ms. At the small shapes (a text
// stream of 256 tokens, 2 x 256 x 3,072: 6 MB, 2 us) the launch and the
// host's call are the limit.
//
// What the design does about it:
//  - one warp holds a whole row in registers as 16-byte vectors (vector
//    i = 32 r + lane in round r), so x is read from HBM once, with all of a
//    lane's loads in flight at once, and the output written once, as 16-byte
//    stores. The row stays packed bf16 (80 registers a lane at 5,120): each
//    pass unpacks it afresh;
//  - a warp walks several rows, and its next row travels by cp.async into
//    the warp's own shared-memory slot while it works on the current one in
//    registers, so a warp always has a row in flight (without it, a warp's
//    loads waited for its arithmetic); the grid is one wave of the blocks
//    the SMs hold where that is at most 4 rows a warp, else blocks of 8 to
//    64 rows;
//  - the widths of the port's models are compile-time instantiations
//    (MC_ROW_WIDTHS): no lane pads to a power of two; 1,152 (144 vectors)
//    ends on a ragged round of 16 lanes. Other multiples of 8 up to
//    kMaxWidth (the test models') run the same body with a runtime width;
//  - the statistics reduce across the warp by shuffles, with no shared
//    memory and no barrier; K2's head scope reduces over half-warps, since
//    a head's 128 channels are 16 vectors;
//  - the f32 tables (K3's scale/shift rows of the block's sample or its
//    affine weight/bias, K2's [H*128] gain) are staged once a block in
//    shared memory, swizzled so that a quarter-warp's 16-byte reads hit
//    distinct banks; a block walks consecutive rows of one sample. A [128]
//    gain shared by every head is 8 values in each lane's registers;
//  - RoPE's pairs never leave a 16-byte vector (4 pairs), and a lane's
//    vectors all sit at the same place in their head (32 lanes = 2 heads a
//    round), so each lane loads its 4 cos and 4 sin once a row, as two
//    16-byte loads from the [S, 64] tables;
//  - a C call through ctypes launches it (no Triton dispatch on the host).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "mma_tile.cuh"

// the widths instantiated at compile time: every row width of the port's
// configs that reaches K2, K3 or K7 (tests/test_torch_prologue_widths.py
// holds the configs to this list)
#define MC_ROW_WIDTHS(X) X(1152) X(1536) X(3072) X(5120)
// a tp rank's slice of Wan's rows: 1.3B at tp 4 / 2 (384, 768), 5B at tp 4 / 2
// (768, 1,536), 14B at tp 4 / 2 (1,280, 2,560); K2's two tp passes take these
#define MC_TP_ROW_WIDTHS(X) X(384) X(768) X(1280) X(1536) X(2560)

namespace {

using mc::bf16;

constexpr int kWarps = 8;                        // a block: 8 warps, a row each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWidth = 5120;                  // the widest row (Wan 14B)
constexpr int kHeadDim = 128;                    // K2's head dim
constexpr int kSMs = 132;

enum Out : int { kAffine = 0, kMod = 1, kPlain = 2, kOperand = 3 };

// 16-byte vectors a lane holds: ceil(W / 8 / 32); the runtime width takes
// the most
template <int W>
struct Rounds {
  static constexpr int value = W ? (W / 8 + 31) / 32 : kMaxWidth / 256;
};

// Registers: K3 takes what it needs; K2 is held to 128 a thread (two blocks
// an SM), with which it ran faster at 5,120 than with more.
constexpr int kRopeMinBlocks = 2;

// Shared-memory offset (floats) of the 4-float chunk c of a staged table:
// within every 16 chunks, 8..15 swap neighbours, so a quarter-warp reading
// chunks 2l or 2l + 1 (lanes l .. l + 7) hits 8 distinct 16-byte bank groups.
// Round r adds 64 chunks, which the swap leaves alone: a lane's offsets are
// chunk_at(2 lane + h) + 256 r floats.
__host__ __device__ __forceinline__ int chunk_at(int c) { return (c ^ ((c >> 3) & 1)) * 4; }

// Stages a table row of `width` f32 values (1 + each, ONE_PLUS) into `s`:
// 16-byte loads, all of a thread's issued before its stores, where the row
// is 16-byte aligned, else one value at a time; null: zeros.
template <int W, bool ONE_PLUS = false>
__device__ __forceinline__ void stage_row(float* s, const float* t, int width) {
  constexpr int kChunks = W ? (W / 4 + kThreads - 1) / kThreads : kMaxWidth / 4 / kThreads;
  const int nch = width / 4;
  if (t == nullptr || (reinterpret_cast<uintptr_t>(t) & 15) == 0) {
    float4 v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      v[k] = t && c < nch ? *reinterpret_cast<const float4*>(t + 4 * c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < nch)
        *reinterpret_cast<float4*>(s + chunk_at(c)) =
            ONE_PLUS ? make_float4(1.f + v[k].x, 1.f + v[k].y, 1.f + v[k].z, 1.f + v[k].w)
                     : v[k];
    }
  } else {
    for (int e = threadIdx.x; e < width; e += kThreads)
      s[chunk_at(e >> 2) + (e & 3)] = ONE_PLUS ? 1.f + t[e] : t[e];
  }
}

__device__ __forceinline__ float4 at4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

// bf16 pair -> f32 pair, exact, as an opaque instruction: each pass over the
// row unpacks afresh instead of keeping 2 f32 registers a value live across
// the passes (which halved the resident warps at the wide rows)
__device__ __forceinline__ float2 unpack(uint32_t w) {
  uint32_t lo, hi;
  asm volatile("shl.b32 %0, %1, 16;" : "=r"(lo) : "r"(w));
  asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(hi) : "r"(w));
  return make_float2(__uint_as_float(lo), __uint_as_float(hi));
}

// a pair rounded to bf16 and back to f32 (one conversion for the two)
__device__ __forceinline__ float2 round2(float a, float b) { return unpack(mc::pack_bf16(a, b)); }

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// vector i = 32 r + lane of the row holds channels 8i .. 8i + 7; a round is
// whole when every lane's vector exists
__device__ __forceinline__ bool held(int r, int lane, int nvec) {
  return (r + 1) * 32 <= nvec || r * 32 + lane < nvec;
}

template <int R>
__device__ __forceinline__ void load_row(uint4 (&v)[R], const bf16* row, int lane, int nvec) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = held(r, lane, nvec) ? *reinterpret_cast<const uint4*>(row + 8 * (r * 32 + lane))
                               : make_uint4(0u, 0u, 0u, 0u);
}

// The next row into the warp's own shared-memory slot by cp.async; each lane
// copies and later reads only its own vectors.
template <int R>
__device__ __forceinline__ void prefetch_row(bf16* slot, const bf16* row, int lane, int nvec) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!held(r, lane, nvec)) continue;
    const int e = 8 * (r * 32 + lane);
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(slot + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(row + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int R>
__device__ __forceinline__ void take_row(uint4 (&v)[R], const bf16* slot, int lane, int nvec) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  load_row(v, slot, lane, nvec);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rows of block `blk`: blocks walk (sample, chunk of rows) pairs,
// `chunks` to a sample; a warp takes rows s0 + warp, s0 + warp + kWarps, ...
struct RowChunk {
  int b, s0, s1;
  __device__ RowChunk(int blk, int chunks, int rows_per_block, int S) {
    b = blk / chunks;
    s0 = (blk % chunks) * rows_per_block;
    s1 = min(S, s0 + rows_per_block);
  }
};

// K3 / K3p / K7's operand over x [B, S, W] contiguous. ta/tb: the f32 tables
// (OUT kMod: scale/shift, kOperand: 1 + scale and shift, rows b / rep with
// row strides ta_stride / tb_stride; kAffine: weight / bias, bias may be
// null; kPlain: unread). Shared memory: the staged tables (2W floats, none
// in plain mode), then a row slot of W values a warp. A warp's first row is
// in flight while the block stages the tables.
template <int W, int OUT>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ ta,
                  const float* __restrict__ tb, long long ta_stride, long long tb_stride,
                  bf16* __restrict__ y, int S, int width_rt, int rows_per_block, int chunks,
                  int rep, float eps) {
  constexpr int R = Rounds<W>::value;
  const int width = W ? W : width_rt;
  const int nvec = width / 8;
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);
  float* sb = sa + width;
  const RowChunk rc(blockIdx.x, chunks, rows_per_block, S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = chunk_at(2 * lane), t1 = chunk_at(2 * lane + 1);
  int s = rc.s0 + warp;
  bf16* slot = reinterpret_cast<bf16*>(sa + (OUT == kPlain ? 0 : 2 * width)) + warp * width;
  if (s < rc.s1) prefetch_row<R>(slot, x + ((size_t)rc.b * S + s) * width, lane, nvec);
  if (OUT != kPlain) {
    const size_t m = OUT == kAffine ? 0 : (size_t)(rc.b / rep);
    const float* ra = ta + m * ta_stride;
    const float* rb = tb ? tb + m * tb_stride : nullptr;
    stage_row<W, OUT == kMod>(sa, ra, width);      // 1 + scale for mod
    stage_row<W>(sb, rb, width);
    __syncthreads();
  }
  for (; s < rc.s1; s += kWarps) {
    const size_t row = (size_t)rc.b * S + s;
    uint4 v[R];
    take_row(v, slot, lane, nvec);
    // K7: the sums in the order of the kernel it replaced
    // (tools/ln_modulate_parent.cu), a lane's vectors in turn, each pair's
    // sum added; K3: four partial sums, one a word, for shorter chains
    float sum4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!held(r, lane, nvec)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack(word(v[r], j));
        sum4[OUT == kOperand ? 0 : j] += f.x + f.y;
      }
    }
    // the slot's values are all in registers now: the next row may overwrite it
    if (s + kWarps < rc.s1) prefetch_row<R>(slot, x + (row + kWarps) * width, lane, nvec);
    const float mean = warp_sum((sum4[0] + sum4[1]) + (sum4[2] + sum4[3])) / width;
    float var4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!held(r, lane, nvec)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack(word(v[r], j));
        const float c0 = f.x - mean, c1 = f.y - mean;
        if (OUT == kOperand) {
          var4[0] += c0 * c0 + c1 * c1;
        } else {
          var4[j] = __fmaf_rn(c0, c0, var4[j]);
          var4[j] = __fmaf_rn(c1, c1, var4[j]);
        }
      }
    }
    const float var = warp_sum((var4[0] + var4[1]) + (var4[2] + var4[3])) / width + eps;
    const float rstd = OUT == kOperand ? rsqrtf(var) : __frcp_rn(__fsqrt_rn(var));
    bf16* yr = y + row * width;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!held(r, lane, nvec)) continue;
      const int i = r * 32 + lane;
      uint32_t o[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {         // 4 channels: one float4 of each table
        float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f), c4 = a4;
        if (OUT != kPlain) {
          a4 = at4(sa + (h ? t1 : t0) + 256 * r);
          c4 = at4(sb + (h ? t1 : t0) + 256 * r);
        }
        const float a[4] = {a4.x, a4.y, a4.z, a4.w}, c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float2 f = unpack(word(v[r], 2 * h + q));
          float y0 = (f.x - mean) * rstd, y1 = (f.y - mean) * rstd;
          if (OUT == kOperand || OUT == kMod) {   // bf16(ln(x)), then one FMA
            const float2 yb = round2(y0, y1);
            y0 = __fmaf_rn(yb.x, a[2 * q], c[2 * q]);
            y1 = __fmaf_rn(yb.y, a[2 * q + 1], c[2 * q + 1]);
          } else if (OUT == kAffine) {
            y0 = __fmaf_rn(y0, a[2 * q], c[2 * q]);
            y1 = __fmaf_rn(y1, a[2 * q + 1], c[2 * q + 1]);
          }
          o[2 * h + q] = mc::pack_bf16(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(yr + 8 * i) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The RoPE'd output of one vector: channels 8i .. 8i + 7 of x scaled by rs,
// times the gain g0 (channels 0-3) / g1 (4-7), rounded, rotated by the
// lane's 4 pairs (cos c, sin n).
__device__ __forceinline__ uint4 rope_vector(const uint4& v, float rs, const float4& g0,
                                             const float4& g1, const float4& c,
                                             const float4& n) {
  const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float cs[4] = {c.x, c.y, c.z, c.w}, sn[4] = {n.x, n.y, n.z, n.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack(word(v, j));
    const float2 yb = round2(__fmul_rn(__fmul_rn(f.x, rs), g[2 * j]),
                             __fmul_rn(__fmul_rn(f.y, rs), g[2 * j + 1]));
    o[j] = mc::pack_bf16(__fmaf_rn(yb.x, cs[j], -__fmul_rn(yb.y, sn[j])),
                         __fmaf_rn(yb.x, sn[j], __fmul_rn(yb.y, cs[j])));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// K2 over rows of H*128 bf16 at x + b * stride_b + s * stride_s; gain: f32
// [H*128], staged in shared memory, or (SHARED) one [128] row for every
// head, whose 8 values a lane needs kept in registers; cos/sin: f32 [S, 64];
// y: [B, S, H, 128] contiguous. Shared memory: the staged gain (none when
// SHARED), then a row slot a warp, as in K3. The head scope finishes each
// round (two heads) before the next; the token scope sums the whole row
// first.
// EXT (token scope only): the row's sum of squares is row_ss[b * S + s],
// summed over every tp rank's slice, and the mean divides it by full_width.
template <int W, bool HEAD, bool SHARED, bool EXT>
__global__ void __launch_bounds__(kThreads, kRopeMinBlocks)
rms_norm_rope_kernel(const bf16* __restrict__ x, long long stride_b, long long stride_s,
                     const float* __restrict__ gain, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, bf16* __restrict__ y, int S,
                     int width_rt, int rows_per_block, int chunks, float eps,
                     const float* __restrict__ row_ss, float full_width) {
  static_assert(!(EXT && HEAD), "the external statistic is the token scope's");
  constexpr int R = Rounds<W>::value;
  const int width = W ? W : width_rt;
  const int nvec = width / 8;
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);
  const RowChunk rc(blockIdx.x, chunks, rows_per_block, S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = chunk_at(2 * lane), t1 = chunk_at(2 * lane + 1);
  const int k0 = (lane % 16) * 8;              // the lane's 8 channels in its head
  const bf16* xb = x + rc.b * stride_b;
  int s = rc.s0 + warp;
  bf16* slot = reinterpret_cast<bf16*>(sg + (SHARED ? 0 : width)) + warp * width;
  if (s < rc.s1) prefetch_row<R>(slot, xb + s * stride_s, lane, nvec);
  float4 g0, g1;
  if (SHARED) {
    g0 = *reinterpret_cast<const float4*>(gain + k0);
    g1 = *reinterpret_cast<const float4*>(gain + k0 + 4);
  } else {
    stage_row<W>(sg, gain, width);
    __syncthreads();
  }
  for (; s < rc.s1; s += kWarps) {
    const float4 c = *reinterpret_cast<const float4*>(cos_t + (size_t)s * 64 + k0 / 2);
    const float4 n = *reinterpret_cast<const float4*>(sin_t + (size_t)s * 64 + k0 / 2);
    uint4 v[R];
    take_row(v, slot, lane, nvec);
    // sums of squares: by round in head scope, four partial sums (one a
    // word) over the row in token scope
    float part[HEAD && R > 4 ? R : 4];
#pragma unroll
    for (int k = 0; k < (HEAD && R > 4 ? R : 4); ++k) part[k] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (EXT || !held(r, lane, nvec)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack(word(v[r], j));
        float& acc = part[HEAD ? r : j];
        acc = __fmaf_rn(f.x, f.x, acc);
        acc = __fmaf_rn(f.y, f.y, acc);
      }
    }
    // the slot's values are all in registers now: the next row may overwrite it
    if (s + kWarps < rc.s1) prefetch_row<R>(slot, xb + (s + kWarps) * stride_s, lane, nvec);
    bf16* yr = y + ((size_t)rc.b * S + s) * width;
    float rs = 0.f;
    if (EXT)
      rs = __frcp_rn(__fsqrt_rn(row_ss[(size_t)rc.b * S + s] / full_width + eps));
    else if (!HEAD)
      rs = __frcp_rn(__fsqrt_rn(warp_sum((part[0] + part[1]) + (part[2] + part[3])) / width +
                                eps));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (HEAD)              // every lane shuffles; a half-warp holds one head
        rs = __frcp_rn(__fsqrt_rn(half_warp_sum(part[HEAD ? r : 0]) / kHeadDim + eps));
      if (!held(r, lane, nvec)) continue;
      const int i = r * 32 + lane;
      if (!SHARED) {
        g0 = at4(sg + t0 + 256 * r);
        g1 = at4(sg + t1 + 256 * r);
      }
      *reinterpret_cast<uint4*>(yr + 8 * i) = rope_vector(v[r], rs, g0, g1, c, n);
    }
  }
}

// K2's tp statistics pass: ss[b * S + s] = the f32 sum of squares of the
// row of `width` bf16 at x + b * stride_b + s * stride_s. A warp a row, the
// lane's vectors all loaded before it sums them; blocks walk the rows with a
// grid stride.
template <int W>
__global__ void __launch_bounds__(kThreads)
row_sumsq_kernel(const bf16* __restrict__ x, long long stride_b, long long stride_s,
                 float* __restrict__ ss, int B, int S, int width_rt) {
  constexpr int R = Rounds<W>::value;
  const int nvec = (W ? W : width_rt) / 8;
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)B * S;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const long long b = row / S, s = row % S;
    uint4 v[R];
    load_row(v, x + b * stride_b + s * stride_s, lane, nvec);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!held(r, lane, nvec)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack(word(v[r], j));
        part[j] = __fmaf_rn(f.x, f.x, part[j]);
        part[j] = __fmaf_rn(f.y, f.y, part[j]);
      }
    }
    const float tot = warp_sum((part[0] + part[1]) + (part[2] + part[3]));
    if (lane == 0) ss[row] = tot;
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = kSMs;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Blocks of `kernel` an SM holds with `smem` bytes of dynamic shared memory
// (allowed above 48 KB first), cached in `cache` as smem << 8 | blocks.
template <typename K>
int resident_blocks(K kernel, size_t smem, std::atomic<long long>& cache) {
  const long long c = cache.load(std::memory_order_relaxed);
  if (c >= 0 && (size_t)(c >> 8) == smem) return (int)(c & 0xff);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  n = std::max(1, std::min(n, 255));
  cache.store(((long long)smem << 8) | n, std::memory_order_relaxed);
  return n;
}

// Rows a block, a multiple of the 8 warps. Up to 4 rows a warp in one wave
// of the `resident` blocks an SM holds, the fewest rows that fit; a larger
// grid takes blocks of 8 to 64 rows, so that the last wave is short.
int rows_per_block(int B, int S, int resident) {
  const long long rows = (long long)B * S;
  const long long slots = (long long)sm_count() * resident;
  if (rows <= slots * kWarps * 4) {
    const long long per_sample = std::max(1LL, slots / B);   // B * ceil(S / rpb) <= slots
    const long long per_block = (S + per_sample - 1) / per_sample;
    return (int)(kWarps * std::max(1LL, (per_block + kWarps - 1) / kWarps));
  }
  const long long per_warp = rows / ((long long)kWarps * sm_count() * 16);
  return kWarps * (int)std::max(1LL, std::min(8LL, per_warp));
}

bool width_ok(int width) { return width > 0 && width % 8 == 0 && width <= kMaxWidth; }

constexpr size_t kSlotBytes = kWarps * sizeof(bf16);   // the warps' row slots, a value of width

template <int W, int OUT>
void launch_layer_norm_w(const bf16* x, const float* ta, const float* tb, long long ta_stride,
                         long long tb_stride, bf16* y, int B, int S, int width, int rep,
                         float eps, cudaStream_t st) {
  static std::atomic<long long> cache{-1};
  const size_t smem = (OUT == kPlain ? 0 : 2 * (size_t)width * sizeof(float)) +
                      kSlotBytes * width;
  const int rpb = rows_per_block(B, S, resident_blocks(layer_norm_kernel<W, OUT>, smem, cache));
  const int chunks = (S + rpb - 1) / rpb;
  layer_norm_kernel<W, OUT><<<(unsigned)((long long)B * chunks), kThreads, smem, st>>>(
      x, ta, tb, ta_stride, tb_stride, y, S, width, rpb, chunks, rep, eps);
}

template <int OUT>
int launch_layer_norm(const void* x, const void* ta, const void* tb, long long ta_stride,
                      long long tb_stride, void* y, int B, int S, int width, int rep, float eps,
                      void* stream) {
  if (!width_ok(width) || B < 1 || S < 1 || rep < 1) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const float *ap = static_cast<const float*>(ta), *bp = static_cast<const float*>(tb);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MC_LN_CASE(Wd)                                                                     \
  case Wd:                                                                                 \
    launch_layer_norm_w<Wd, OUT>(xp, ap, bp, ta_stride, tb_stride, yp, B, S, width, rep,   \
                                 eps, st);                                                 \
    break;
  switch (width) {
    MC_ROW_WIDTHS(MC_LN_CASE)
    default:
      launch_layer_norm_w<0, OUT>(xp, ap, bp, ta_stride, tb_stride, yp, B, S, width, rep, eps,
                                  st);
  }
#undef MC_LN_CASE
  return (int)cudaGetLastError();
}

template <int W, bool HEAD, bool SHARED, bool EXT = false>
void launch_rms_norm_rope_w(const bf16* x, long long stride_b, long long stride_s,
                            const float* gain, const float* cos_t, const float* sin_t, bf16* y,
                            int B, int S, int width, float eps, cudaStream_t st,
                            const float* row_ss = nullptr, int full_width = 0) {
  static std::atomic<long long> cache{-1};
  const size_t smem = (SHARED ? 0 : (size_t)width * sizeof(float)) + kSlotBytes * width;
  const int rpb = rows_per_block(
      B, S, resident_blocks(rms_norm_rope_kernel<W, HEAD, SHARED, EXT>, smem, cache));
  const int chunks = (S + rpb - 1) / rpb;
  rms_norm_rope_kernel<W, HEAD, SHARED, EXT>
      <<<(unsigned)((long long)B * chunks), kThreads, smem, st>>>(
          x, stride_b, stride_s, gain, cos_t, sin_t, y, S, width, rpb, chunks, eps, row_ss,
          (float)full_width);
}

template <int W>
void launch_row_sumsq_w(const bf16* x, long long stride_b, long long stride_s, float* ss,
                        int B, int S, int width, cudaStream_t st) {
  const long long blocks = ((long long)B * S + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)std::min<long long>(blocks, (long long)sm_count() * 16);
  row_sumsq_kernel<W><<<grid, kThreads, 0, st>>>(x, stride_b, stride_s, ss, B, S, width);
}

template <bool HEAD, bool SHARED>
int launch_rms_norm_rope(const void* x, long long stride_b, long long stride_s,
                         const void* gain, const void* cos_t, const void* sin_t, void* y, int B,
                         int S, int width, float eps, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gain);
  const float *cp = static_cast<const float*>(cos_t), *sp = static_cast<const float*>(sin_t);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MC_ROPE_CASE(Wd)                                                                   \
  case Wd:                                                                                 \
    launch_rms_norm_rope_w<Wd, HEAD, SHARED>(xp, stride_b, stride_s, gp, cp, sp, yp, B, S, \
                                             width, eps, st);                              \
    break;
  switch (width) {
    MC_ROW_WIDTHS(MC_ROPE_CASE)
    default:
      launch_rms_norm_rope_w<0, HEAD, SHARED>(xp, stride_b, stride_s, gp, cp, sp, yp, B, S,
                                              width, eps, st);
  }
#undef MC_ROPE_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// K3 (mode 0 affine, 1 mod) and K3p (mode 2 plain): y [B, S, width] from x
// [B, S, width], both contiguous bf16. mod: ta / tb are f32 scale / shift
// rows of `width` values, sample b's at b * ta_stride / b * tb_stride (0:
// one row for every sample); affine: weight / bias [width] (bias may be
// null: zero).
extern "C" int mc_layer_norm_mod(const void* x, const void* ta, const void* tb,
                                 long long ta_stride, long long tb_stride, void* y, int B,
                                 int S, int width, int mode, float eps, void* stream) {
  switch (mode) {
    case kAffine:
      return launch_layer_norm<kAffine>(x, ta, tb, 0, 0, y, B, S, width, 1, eps, stream);
    case kMod:
      return launch_layer_norm<kMod>(x, ta, tb, ta_stride, tb_stride, y, B, S, width, 1, eps,
                                     stream);
    case kPlain:
      return launch_layer_norm<kPlain>(x, nullptr, nullptr, 0, 0, y, B, S, width, 1, eps,
                                       stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K7's operand: y [B, S, K] from x [B, S, K], both contiguous bf16;
// scale1p (1 + scale) and shift are contiguous f32 [B / rep, K].
extern "C" int mc_ln_modulate(const void* x, const void* scale1p, const void* shift, void* y,
                              int B, int S, int K, int rep, float eps, void* stream) {
  return launch_layer_norm<kOperand>(x, scale1p, shift, K, K, y, B, S, K, rep, eps, stream);
}

// K2: y [B, S, H, 128] contiguous bf16 from rows of H*128 bf16 at x +
// b * stride_b + s * stride_s (elements; 16-byte aligned); gain f32 [H*128],
// or in head scope [128] shared by every head (shared_gain 1); cos / sin f32
// [S, 64]; head_scope 0: the norm over the whole row, 1: over each head.
extern "C" int mc_rms_norm_rope(const void* x, long long stride_b, long long stride_s,
                                const void* gain, int shared_gain, const void* cos_t,
                                const void* sin_t, void* y, int B, int S, int heads,
                                int head_scope, float eps, void* stream) {
  const int width = heads * kHeadDim;
  if (!width_ok(width) || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (!head_scope)
    return shared_gain ? (int)cudaErrorInvalidValue
                       : launch_rms_norm_rope<false, false>(x, stride_b, stride_s, gain, cos_t,
                                                            sin_t, y, B, S, width, eps, stream);
  return shared_gain ? launch_rms_norm_rope<true, true>(x, stride_b, stride_s, gain, cos_t,
                                                        sin_t, y, B, S, width, eps, stream)
                     : launch_rms_norm_rope<true, false>(x, stride_b, stride_s, gain, cos_t,
                                                         sin_t, y, B, S, width, eps, stream);
}

// K2's tp statistics pass: ss [B, S] f32 contiguous, the sum of squares of
// each row of `width` bf16 at x + b * stride_b + s * stride_s (elements;
// rows 16-byte aligned).
extern "C" int mc_row_sumsq(const void* x, long long stride_b, long long stride_s, void* ss,
                            int B, int S, int width, void* stream) {
  if (!width_ok(width) || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  float* sp = static_cast<float*>(ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MC_SS_CASE(Wd)                                           \
  case Wd:                                                       \
    launch_row_sumsq_w<Wd>(xp, stride_b, stride_s, sp, B, S, width, st); \
    break;
  switch (width) {
    MC_TP_ROW_WIDTHS(MC_SS_CASE)
    default:
      launch_row_sumsq_w<0>(xp, stride_b, stride_s, sp, B, S, width, st);
  }
#undef MC_SS_CASE
  return (int)cudaGetLastError();
}

// K2's tp apply pass (token scope): as mc_rms_norm_rope over this rank's H
// heads, with each row's sum of squares read from row_ss [B, S] f32 (every
// tp rank's slice summed) and its mean taken over full_width values.
extern "C" int mc_rms_norm_rope_ext(const void* x, long long stride_b, long long stride_s,
                                    const void* gain, const void* cos_t, const void* sin_t,
                                    const void* row_ss, int full_width, void* y, int B, int S,
                                    int heads, float eps, void* stream) {
  const int width = heads * kHeadDim;
  if (!width_ok(width) || B < 1 || S < 1 || full_width < width)
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gain);
  const float *cp = static_cast<const float*>(cos_t), *snp = static_cast<const float*>(sin_t);
  const float* ssp = static_cast<const float*>(row_ss);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MC_EXT_CASE(Wd)                                                                    \
  case Wd:                                                                                 \
    launch_rms_norm_rope_w<Wd, false, false, true>(xp, stride_b, stride_s, gp, cp, snp, yp, \
                                                   B, S, width, eps, st, ssp, full_width); \
    break;
  switch (width) {
    MC_TP_ROW_WIDTHS(MC_EXT_CASE)
    default:
      launch_rms_norm_rope_w<0, false, false, true>(xp, stride_b, stride_s, gp, cp, snp, yp,
                                                    B, S, width, eps, st, ssp, full_width);
  }
#undef MC_EXT_CASE
  return (int)cudaGetLastError();
}
