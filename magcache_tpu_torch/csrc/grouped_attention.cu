// K5, K5r and K4: block-diagonal grouped attention, bf16, head dim 72, with
// an optional per-head RMS qk-norm and in-group RoPE, and a fixed or a
// row-max softmax shift.
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
// bound. The temporal calls (groups of T = 15 or 16 frames, 3,180 to 7,200
// groups x 16 heads) do about 4 x 16 x 72 flops a byte: they are bound by
// their bytes (0.44-1.0 GB of qkv and output).
//
// Three routes, chosen by the arguments alone (ops/attention.py:grouped_kernel):
//   - "tma": the row max without gains or RoPE on groups of more than 16
//     tokens (K5r spatial: Latte's frames; K4 with the same arguments) runs
//     the warp-specialised wgmma/TMA body of hopper_attention.cuh at head
//     dim 80 = 72 + a zero pad the tensor map supplies, mode kRowMax (QK^T
//     over the group's keys once for each row's true max, then softmax and
//     PV with that shift), grouped geometry. q is scaled in shared memory
//     after its copy: q * (scale*log2(e)) in f32, rounded once. Its TMA
//     maps are 5-D (column, head, in-group position, group, batch) over the
//     tensors' own byte strides, the position extent group (q) or
//     group_valid (k, v), so positions past them arrive as zeros;
//   - "prepass": groups of more than 16 tokens with gains or RoPE (K5
//     spatial, fixed max; any such call with the row max): two launches.
//     flash_attention.cu's qk_norm_kernel writes contiguous q^ (normed,
//     rotated at token % group, scaled, rounded) and k^ (normed, rotated,
//     rounded; positions past group_valid not written), then the same body
//     at <80, kFixed or kRowMax, grouped> with q_scale 1 reads q^, k^ and v
//     in place through the 5-D maps. The norm is done once per row: the
//     mma.sync kernel this replaces normalised every K tile again in each
//     of a frame's 25 query blocks (125 TFLOP/s at 480p on an H100);
//   - "stream": groups of up to 16 tokens (K5 and K5r temporal, K4 on
//     Latte), grouped_stream_kernel below.
//
// grouped_stream_kernel is built for HBM bandwidth. A task is one (group,
// head); a stage is one group's heads 8j .. 8j + 7, one a consumer warp.
// Persistent blocks (one an SM: 8 consumer warps and a producer warp) walk
// a contiguous range of stages front to back through a ring of three
// shared-memory stages (the skeleton of stream_ring.cuh, which K9's
// tiny_stream_kernel shares). The producer issues three TMA loads a stage,
// one box of 72 columns x 16 positions x 8 heads each of q, k and v over
// 5-D maps of the tensors' own strides (a token's 8 heads are 1,152
// contiguous bytes); positions past group or group_valid and heads past H
// arrive as zeros, without being read. Rows land 144 bytes apart, which
// keeps ldmatrix conflict-free; the products never use columns 72..79 (the
// fifth k-step of Q K^T is an m16n8k8, P V leaves its tenth n8 tile out).
// The block keeps the gains [H, 72] and the RoPE tables [group, 36] in
// shared memory. A consumer warp writes its task's q^ (lane r: row r; the
// norm, RoPE and q's scale are template parameters) and, with the norm or
// RoPE, k^ (lane 16 + r) to its own scratch rows, does the 16 x 16 score
// tile and the 16 x 72 output with mma.sync m16n8k16 in one k-step (a row's
// 16 scores sit in one quad of lanes: its max is two shuffles), releases
// the stage as soon as P V has read V, divides each value by its row's l
// (correctly rounded, as the reference's o / l) and stores the output rows
// from its scratch with 16-byte stores. The ring is written only by the
// copy engine and read only by the consumers, so no proxy fence sits in the
// loop. mma.sync stays the right instruction here: wgmma's M = 64 would
// waste three quarters of each product on 16-row block-diagonal groups.
//
// What the design steps measured on an H100 SXM (tools/time_stdit3_kernels.py,
// PERF.md section 6, PR 10): cp.async into the ring with one block of
// eight warps an SM reached 1.1-1.8 TB/s (address arithmetic and the
// in-place norm on the ring's critical path); one bulk copy a 144-byte row
// was slower still; the TMA boxes, the scratch rows and the early release
// reach 2.2-2.6 TB/s.

#include "hopper_attention.cuh"
#include "mma_tile.cuh"
#include "stream_ring.cuh"

namespace {

using mc::bf16;
using stream_ring::kBoxElems;
using stream_ring::kD;                              // 72
using stream_ring::kRows;
using stream_ring::kSlotElems;
using stream_ring::kSlots;
using stream_ring::kStageElems;
using stream_ring::kThreads;
using stream_ring::StreamMaps;

constexpr int kRing = 3;                            // stages in shared memory
constexpr int kDP = mc::kHDP;                       // 80: five k16 steps
constexpr int kStr = mc::kHStr;                     // 72: a head row in shared memory
constexpr int kChunks = kD / 8;                     // 16-byte chunks a head row
constexpr int kScratchElems = 2 * kSlotElems;       // a warp's q^ (then o) and k^

struct StreamArgs {
  bf16* out;            // [n_groups * group, H*72]
  const float* qg;      // [H, 72], or null: no qk-norm
  const float* kg;
  const float* cos;     // [group, 36] or null
  const float* sin;
  int gpb, H, group, gvalid, rowmax;              // gpb: groups per batch row
  int n_stages, per_block;                        // stages; a block's range
  float q_scale, inv_true_d, eps, m_const;
};

// One q or k head row from src to dst (both in shared memory): RMS norm
// over its 72 values times the gain (kNorm), RoPE by the 36 angles of
// cs/sn (kRope), times mult, rounded to bf16.
template <bool kNorm, bool kRope>
__device__ __forceinline__ void prep_row(bf16* dst, const bf16* src, const float* gain,
                                         const float* cs, const float* sn, float mult,
                                         float inv_true_d, float eps) {
  uint4 raw[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) raw[c] = reinterpret_cast<const uint4*>(src)[c];
  uint32_t* w = reinterpret_cast<uint32_t*>(raw);
  float r = 1.f;
  if (kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) {
      const float2 x = mc::unpack_bf16(w[i]);
      ss += x.x * x.x + x.y * x.y;
    }
    r = rsqrtf(ss * inv_true_d + eps);
  }
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    const float2 x = mc::unpack_bf16(w[i]);
    float ye = x.x, yo = x.y;
    if (kNorm) {
      const float2 g = reinterpret_cast<const float2*>(gain)[i];
      ye = x.x * r * g.x;
      yo = x.y * r * g.y;
    }
    if (kRope) {
      const float c = cs[i], s = sn[i];
      const float re = ye * c - yo * s;
      const float ro = ye * s + yo * c;
      ye = re;
      yo = ro;
    }
    w[i] = mc::pack_bf16(ye * mult, yo * mult);
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) reinterpret_cast<uint4*>(dst)[c] = raw[c];
}

// Groups of up to 16 tokens: a persistent block streams stages
// [blockIdx.x * per_block, + per_block) through the ring; stage s is heads
// 8(s % hc) .. + 7 of group s / hc, hc = ceil(H / 8). Warps 0..7 are
// consumers (warp w takes head slot w); warp 8 is the producer. The ring is
// written only by the copy engine and read only by the consumers; a
// consumer writes q^ (and k^ with the norm or RoPE), then its output, to its
// own scratch rows, and releases the stage as soon as P V has read V.
template <bool kNorm, bool kRope>
__global__ void __launch_bounds__(kThreads, 1)
grouped_stream_kernel(const __grid_constant__ StreamMaps maps, const StreamArgs p) {
  constexpr bool kPrepK = kNorm || kRope;
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(stream_ring::aligned_smem(smem_raw));
  bf16* scratch = ring + kRing * kStageElems;                       // [8][2][16][72]
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch + kSlots * kScratchElems);
  uint64_t* empty = full + kRing;
  float* gains = reinterpret_cast<float*>(empty + kRing);          // [2][H][72]
  float* tabs = gains + (kNorm ? 2 * p.H * kD : 0);                // [2][group][36]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hc = (p.H + kSlots - 1) / kSlots;
  const int s0 = blockIdx.x * p.per_block;
  const int s1 = min(p.n_stages, s0 + p.per_block);

  // scratch rows past group (q) or group_valid (k) are never written: zeros
  for (int i = tid; i < kSlots * kScratchElems / 8; i += kThreads)
    reinterpret_cast<uint4*>(scratch)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (kNorm)
    for (int i = tid; i < 2 * p.H * kD; i += kThreads)
      gains[i] = i < p.H * kD ? p.qg[i] : p.kg[i - p.H * kD];
  if (kRope)
    for (int i = tid; i < p.group * kD; i += kThreads)
      tabs[i] = i < p.group * (kD / 2) ? p.cos[i] : p.sin[i - p.group * (kD / 2)];
  if (tid == 0) stream_ring::init_barriers<kRing>(full, empty);
  __syncthreads();

  if (warp == kSlots) {
    // ---- producer: three boxes a stage; positions past group (q) or
    // group_valid (k, v) and heads past H arrive as zeros
    if (lane == 0) stream_ring::produce<kRing>(maps, ring, full, empty, s0, s1, hc, p.gpb);
    return;
  }

  // ---- consumers ----
  const size_t ld = (size_t)p.H * kD;
  bf16* Qn = scratch + warp * kScratchElems;                // q^, then the output
  bf16* Kn = Qn + kSlotElems;                               // k^
  for (int s = s0, it = 0; s < s1; ++s, ++it) {
    const int buf = it % kRing;
    const int g = s / hc, h = (s % hc) * kSlots + warp;
    const bf16* Qs = ring + buf * kStageElems + warp * kSlotElems;
    const bf16* Ks = Qs + kBoxElems;
    const bf16* Vs = Qs + 2 * kBoxElems;
    // every warp waits, so none arrives on a stage's "empty" ahead of it
    hopper::mbar_wait(&full[buf], (it / kRing) & 1);
    if (h >= p.H) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[buf]);
      continue;
    }
    // lane r: q row r; lane 16 + r: k row r (without the norm or RoPE k is
    // read from the ring as it is)
    const bool is_k = lane >= 16;
    const int r = lane & 15;
    if (!is_k && r < p.group)
      prep_row<kNorm, kRope>(Qn + r * kStr, Qs + r * kStr, gains + h * kD,
                             tabs + r * (kD / 2), tabs + (p.group + r) * (kD / 2),
                             p.q_scale, p.inv_true_d, p.eps);
    if (kPrepK && is_k && r < p.gvalid)
      prep_row<kNorm, kRope>(Kn + r * kStr, Ks + r * kStr, gains + (p.H + h) * kD,
                             tabs + r * (kD / 2), tabs + (p.group + r) * (kD / 2), 1.f,
                             p.inv_true_d, p.eps);
    __syncwarp();

    uint32_t qf[kDP / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) mc::load_a_frag(qf[kk], Qn + kk * 16, kStr);
    float sc[2][4];
    mc::qk_scores<2>(sc, qf, kPrepK ? Kn : Ks);
    float m[2] = {p.m_const, p.m_const};
    if (p.rowmax) {
      m[0] = m[1] = mc::kNegInf;
      mc::row_max_update<2>(sc, m, 0, p.gvalid);
      m[0] = mc::quad_max(m[0]);
      m[1] = mc::quad_max(m[1]);
    }
    float acc[kDP / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float l[2] = {0.f, 0.f};
    mc::shifted_softmax_pv<2>(sc, l, acc, Vs, 0, p.gvalid, m);
    __syncwarp();                 // the stage is read: release it
    if (lane == 0) hopper::mbar_arrive(&empty[buf]);
    mc::store_head_rows(Qn, p.group, acc, l, kStr);
    __syncwarp();
    // out: the head's rows, 16 bytes a lane
    bf16* dst = p.out + (size_t)g * p.group * ld + h * kD;
    for (int i = lane; i < p.group * kChunks; i += 32) {
      const int row = i / kChunks, c = i % kChunks;
      *reinterpret_cast<uint4*>(dst + row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(Qn + row * kStr + c * 8);
    }
    __syncwarp();                 // the scratch rows are read
  }
}

// out[i] = acc[i] / l[i] through the stream store's division (a test entry).
__global__ void row_quotient_kernel(const float* acc, const float* l, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mc::row_quotient(acc[i], l[i], mc::row_reciprocal(l[i]));
}

template <bool kNorm, bool kRope>
int launch_stream(const StreamMaps& m, const StreamArgs& a, int grid, int smem_bytes,
                  cudaStream_t stream) {
  auto kernel = grouped_stream_kernel<kNorm, kRope>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The "stream" route: groups of up to 16 tokens, q, k and v described by
// `maps` (ops/attention.py:stream_tma_maps). `grid` blocks of `per_block`
// stages each and `smem_bytes` of dynamic shared memory
// (ops/attention.py:stream_geometry).
extern "C" int mc_grouped_stream(const void* q, const void* k, const void* v,
                                 const long long* maps, void* out, const void* qg,
                                 const void* kg, const void* cos, const void* sin,
                                 int n_groups, int gpb, int H, int group, int gvalid,
                                 int rowmax, float q_scale, float true_d, float eps,
                                 float m_const, int grid, int per_block, int smem_bytes,
                                 void* stream) {
  StreamMaps m;
  const int err = stream_ring::encode_maps(&m, q, k, v, maps);
  if (err) return err;
  StreamArgs a{};
  a.out = static_cast<bf16*>(out);
  a.qg = static_cast<const float*>(qg);
  a.kg = static_cast<const float*>(kg);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.gpb = gpb;
  a.H = H;
  a.group = group;
  a.gvalid = gvalid;
  a.rowmax = rowmax;
  a.n_stages = n_groups * ((H + kSlots - 1) / kSlots);
  a.per_block = per_block;
  a.q_scale = q_scale;
  a.inv_true_d = 1.f / true_d;
  a.eps = eps;
  a.m_const = m_const;
  if (group > kRows || (long long)grid * per_block < a.n_stages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qg != nullptr)
    return cos != nullptr ? launch_stream<true, true>(m, a, grid, smem_bytes, st)
                          : launch_stream<true, false>(m, a, grid, smem_bytes, st);
  return cos != nullptr ? launch_stream<false, true>(m, a, grid, smem_bytes, st)
                        : launch_stream<false, false>(m, a, grid, smem_bytes, st);
}

// The stream store's division over n (acc, l) pairs of f32: the test of its
// rounding against torch.div.
extern "C" int mc_row_quotient(const void* acc, const void* l, void* out, int n,
                               void* stream) {
  row_quotient_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(l), static_cast<float*>(out),
      n);
  return (int)cudaGetLastError();
}

// The "tma" (q scaled in the body, q_scale = scale*log2(e), row max) and
// "prepass" (q^ and k^ from mc_qk_prepass, q_scale 1, fixed max or row max)
// routes: the wgmma/TMA body (hopper_attention.cuh, head dim 80, grouped
// geometry) on q, k and v described by `maps`
// (ops/attention.py:grouped_tma_maps); out is [n_groups * group, H*72].
extern "C" int mc_grouped_attention_tma(const void* q, const void* k, const void* v,
                                        void* out, const long long* maps, int n_groups,
                                        int gpb, int H, int group, int gvalid,
                                        float q_scale, int fixed, float m_const,
                                        void* stream) {
  hopper::Args a{};
  a.o = static_cast<bf16*>(out);
  a.H = H;
  a.Sq = group;
  a.kv_len = gvalid;
  a.gpb = gpb;
  a.q_scale = q_scale;
  a.m_const = m_const;
  const dim3 grid((group + hopper::kBlockM - 1) / hopper::kBlockM, n_groups, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fixed) return hopper::launch<80, hopper::kFixed, true>(q, k, v, maps, a, grid, st);
  return hopper::launch<80, hopper::kRowMax, true>(q, k, v, maps, a, grid, st);
}
